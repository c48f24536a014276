"""Detection extraction — fixed-capacity top-K with validity mask.

The reference zero-suppresses the CFAR stream and forwards up to 64
detections per scan (rtl/src/radar_core.vhd:413-418, tws_tracker.vhd:66-76);
the framework extracts the K strongest detections into fixed arrays with a
validity mask.  Port of ``fmcw_tpu/ops/detect.topk_detections`` with
``lax.top_k``'s tie order (equal values: lower index first), which
``torch.topk`` does not promise on CUDA — so the selection is a stable
descending sort.
"""

from __future__ import annotations

import torch


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries along the last axis, equal
    values in ascending index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_detections(det_map: torch.Tensor, max_dets: int = 64,
                    row_max: torch.Tensor | None = None,
                    n_dets: torch.Tensor | None = None) -> dict:
    """Extract the ``max_dets`` strongest nonzero cells of (..., R, D)
    detection maps, float32 or int32 (the fixed chain's).  Returns a dict
    with range_bin, doppler_bin (int32), mag (the map's dtype), valid
    (bool) — each (..., max_dets) — and n_dets (total nonzero count per
    map, int32; it may exceed max_dets).

    Large maps use the exact row-select reduction of the JAX package: the
    ``max_dets`` rows with the largest row maxima (``row_max``, (..., R),
    which the CUDA kernel emits), re-sorted ascending, then a flat top-k
    over just those rows — identical to one flat top-k including ties."""
    *lead, R, D = det_map.shape
    if R * D > 16384 and R >= max_dets:
        if row_max is None:
            row_max = det_map.amax(dim=-1)
        rows = top_k(row_max, max_dets)[1].sort(dim=-1).values
        sub = torch.gather(det_map, -2,
                           rows.unsqueeze(-1).expand(*lead, max_dets, D))
        vals, i2 = top_k(sub.reshape(*lead, max_dets * D), max_dets)
        range_bin = torch.gather(rows, -1, torch.div(i2, D,
                                                     rounding_mode="floor"))
        doppler_bin = i2 % D
    else:
        vals, idx = top_k(det_map.reshape(*lead, R * D), max_dets)
        range_bin = torch.div(idx, D, rounding_mode="floor")
        doppler_bin = idx % D
    if n_dets is None:
        n_dets = (det_map > 0).sum(dim=(-2, -1))
    return {
        "range_bin": range_bin.to(torch.int32),
        "doppler_bin": doppler_bin.to(torch.int32),
        "mag": vals,
        "valid": vals > 0,
        "n_dets": n_dets.to(torch.int32),
    }
