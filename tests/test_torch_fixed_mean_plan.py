"""A numpy model of the fixed slow-time kernel's CA/GO/SO plan (the kMean
instantiation of fmcw_tpu_torch/csrc/slowtime_detect_fixed.cu, cfar_tile.cuh's
strip_decide_mean with IntInFloat), held against the port's plain integer
CFAR on the CPU.

The kernel holds the integer magnitudes in float.  Its plan, modelled here:

* a column's partial sum (2 hr + 1 or 2 gr + 1 rows, ascending) and a row's
  (2 hd + 1 columns, ascending) are float32 adds, exact while below 2^24;
* every sum across partial sums (the full and guard boxes, the GO/SO lead
  and lag halves) accumulates in int;
* the means are floor divisions, the per-cell thresholds mean + (mean >> 1)
  and mean >> 1, the block scale the twin's block_scale_map (the kernel's
  block_scale_tile, shared with the OS instantiation);
* the decision is est < ceil(cut / scale), never est * scale.

The model equals ``ops/cfar.cfar_2d`` on maps near the fixed chain's
largest magnitude (45,056), where a 17x23 window's sums pass 2^24, on
constant maps (window sums exact multiples of their counts), on a level
map whose 500-cell sums pass 2^24 under a scale of 1, and under a scale
override of 2^20.  Three mutations of the plan (float32 sums across
columns, an int32 product est * scale, a rounded mean) each change a
decision on those maps.
"""

import numpy as np
import pytest
import torch

import fmcw_tpu_torch
from fmcw_tpu_torch.ops import cfar as C

F32 = np.float32
MAX_MAG = 45056          # 32768 + 8192 + 4096: the fixed chain's largest
WIDE = fmcw_tpu_torch.CfarParams(ref_range=6, guard_range=2, ref_doppler=9,
                                 guard_doppler=2)
# 500 training cells: a CA mean below the largest magnitude from a sum past
# 2^24, so that at scale 1 float32 sums can move a decision.
BIG = fmcw_tpu_torch.CfarParams(variant="ca", ref_range=8, guard_range=2,
                                ref_doppler=10, guard_doppler=2)


def _f32_sum(views):
    """Ascending float32 adds from -0, as the kernel's partial sums."""
    acc = np.full(views[0].shape, -0.0, F32)
    for v in views:
        acc = (acc + v.astype(F32)).astype(F32)
    return acc


def _cross_sum(views, acc_dtype):
    """The sum across partial sums: int in the kernel (exact), float32 in
    the mutation."""
    if acc_dtype is F32:
        return _f32_sum(views).astype(np.int64)
    acc = np.zeros(views[0].shape, np.int64)
    for v in views:
        acc = acc + v.astype(np.int64)
    return acc


def mean_model(mag, cfar, so=0, acc_dtype=np.int64, product=None,
               rounded_mean=False):
    """The kMean plan's det map of int32 maps (B, R, D), columns and rows
    wrapping; mutations: ``acc_dtype`` F32, ``product`` an integer dtype for
    est * scale, ``rounded_mean`` a rounded in place of a floor mean."""
    m = np.asarray(mag)
    B, R, D = m.shape
    hr, hd = cfar.halo_range, cfar.halo_doppler
    gr, gd = cfar.guard_range, cfar.guard_doppler
    p = np.pad(m, ((0, 0), (hr, hr), (hd, hd)), mode="wrap").astype(F32)

    def cell(dr, dd):
        return p[:, hr + dr:hr + dr + R, hd + dd:hd + dd + D]

    def box(h_r, h_d):
        cols = {dd: _f32_sum([cell(dr, dd) for dr in range(-h_r, h_r + 1)])
                for dd in range(-h_d, h_d + 1)}
        return _cross_sum([cols[dd] for dd in sorted(cols)], acc_dtype)

    def half(rows):
        rs = [_f32_sum([cell(dr, dd) for dd in range(-hd, hd + 1)])
              for dr in rows]
        return _cross_sum(rs, acc_dtype)

    def mean(s, n):
        return np.floor(s / n + 0.5).astype(np.int64) if rounded_mean \
            else s // n

    sum_refs = box(hr, hd) - box(gr, gd)
    if cfar.variant == "ca":
        est = mean(sum_refs, cfar.n_ref)
    else:
        n_half = cfar.ref_range * cfar.win_doppler
        ml = mean(half(range(-hr, -gr)), n_half)
        mg = mean(half(range(gr + 1, hr + 1)), n_half)
        est = np.maximum(ml, mg) if cfar.variant == "go" else np.minimum(ml,
                                                                       mg)
    if so:
        sc = np.full(m.shape, so, np.int64)
    elif cfar.scale_mode == "block":
        sc = C.block_scale_map(torch.as_tensor(m), cfar).numpy()
        sc = sc.astype(np.int64)
    else:
        mu = mean(sum_refs, cfar.n_ref)
        sc = np.where(est > mu + (mu >> 1), cfar.scale_max,
                      np.where(est < (mu >> 1), cfar.scale_min,
                               cfar.scale_nom))
    cut = m.astype(np.int64)
    if product is not None:
        keep = cut > (est.astype(product) * sc.astype(product))
    else:
        keep = est < (cut - 1) // sc + 1          # ceil(cut / sc)
    return np.where(keep, m, 0).astype(np.int32)


def _maps(rng, B=2, R=64, D=64):
    """Adversarial int32 maps: near the chain's largest magnitude (window
    sums past 2^24 for a 17x23 window), noise with hot patches, and a
    constant map with spikes (window sums exact multiples of the counts)."""
    hot = rng.integers(MAX_MAG - 1500, MAX_MAG + 1, (B, R, D))
    noise = rng.integers(0, 4000, (B, R, D))
    noise[:, 10:30, 5:25] += rng.integers(20000, 40000, (B, 20, 20))
    noise[:, 40, 50] = MAX_MAG
    flat = np.full((B, R, D), 3000)
    flat[:, ::7, ::5] = 9000
    return {k: np.minimum(v, MAX_MAG).astype(np.int32)
            for k, v in (("hot", hot), ("noise", noise), ("flat", flat))}


def _twin(m, cfar, so):
    det, _, _ = C.cfar_2d(torch.as_tensor(m), so, cfar)
    return det.numpy()


def _cfars():
    out = []
    for variant in ("ca", "go", "so"):
        for window in (fmcw_tpu_torch.CfarParams(), WIDE):
            for mode in ("cell", "block"):
                out.append(window.__class__(
                    **{**window.__dict__, "variant": variant,
                       "scale_mode": mode}))
    return out


@pytest.mark.parametrize("cfar", _cfars(),
                         ids=lambda c: f"{c.variant}-{c.scale_mode}-"
                                       f"{c.win_range}x{c.win_doppler}")
def test_mean_plan_equals_twin(cfar):
    rng = np.random.default_rng(7)
    for name, m in _maps(rng).items():
        for so in (0, 6, 1 << 20):
            got = mean_model(m, cfar, so)
            assert np.array_equal(got, _twin(m, cfar, so)), (name, so)


def test_wide_sums_pass_2_24_on_the_hot_map():
    """The 17x23 window's full box on the hot map sums past 2^24, where a
    float32 sum is no longer exact: the plan needs its int cross sums."""
    m = _maps(np.random.default_rng(7))["hot"]
    assert WIDE.win_range * WIDE.win_doppler * int(m.min()) > 1 << 24


def test_mutations_change_decisions():
    """Each mutation of the plan changes some decision on these maps."""
    rng = np.random.default_rng(7)
    maps = _maps(rng)
    ca_wide = fmcw_tpu_torch.CfarParams(variant="ca", **{
        k: getattr(WIDE, k) for k in ("ref_range", "guard_range",
                                      "ref_doppler", "guard_doppler")})
    # Cells within a few counts of their 500-cell mean (~40,000; the sums
    # near 2^24.25), decided at scale 1.
    maps["level"] = rng.integers(39990, 40011, (2, 64, 64)).astype(np.int32)
    seen = {"float32 sums": False, "int32 product": False,
            "rounded mean": False}
    for name, m in maps.items():
        for cfar in (ca_wide, BIG, fmcw_tpu_torch.CfarParams(variant="go")):
            for so in (0, 1, 1 << 20):
                want = _twin(m, cfar, so)
                assert np.array_equal(mean_model(m, cfar, so), want)
                seen["float32 sums"] |= not np.array_equal(
                    mean_model(m, cfar, so, acc_dtype=F32), want)
                seen["int32 product"] |= not np.array_equal(
                    mean_model(m, cfar, so, product=np.int32), want)
                seen["rounded mean"] |= not np.array_equal(
                    mean_model(m, cfar, so, rounded_mean=True), want)
    assert all(seen.values()), seen
