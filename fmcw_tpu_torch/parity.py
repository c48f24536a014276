"""Detection-set parity: the float margin gate and the fixed-mode check.

Two float implementations of the chain (the port's kernels, its plain
twins, the JAX package's bf16x3 fused kernel and its HIGHEST-precision XLA
chain) agree on the magnitude map to ~1e-5 of its peak, but not bit for bit,
so a cell whose CFAR decision or grouping tie sits within that difference
may land on one side only.  ``margin_gate`` accepts exactly those:

1. detections on both sides agree in magnitude within ``tol``;
2. a detection on one side only is accepted if, within its (2r+1)^2
   neighbourhood (wrapped), some cell has |M - T| <= (1 + S) * tol (a
   decision at the threshold) or some neighbour has |M_n - M_c| <= 2 * tol
   (a grouping tie);
3. at most 20% of the larger set differs;
4. the golden targets are found (if given).

With ``capacity`` (the top-K size), a one-sided entry of a full top-K list
is also accepted when its magnitude is within ``tol`` of the smaller of the
two lists' last entries: the cut between the K-th and the (K+1)-th
detection moved.

M, T and S are a reference's magnitude, threshold and scale maps and
``tol = 1e-5 * max(M)``.  The gate takes numpy arrays; it is used by the
tests against the JAX package and by ``chip_smoke.py`` on the card.

``array_gate`` carries the gate to the array model's (beam, range, Doppler)
cubes: the near-threshold test looks in the cell's own beam's
neighbourhood, a grouping tie may also be with the same cell of a beam
within ``beam_radius`` (cross-beam grouping), the strongest detection must
be the same on both sides, and the golden targets must be found at the
matched beam.

Fixed mode (``fixed_gate``) carries no float: two routes of the integer
chain that compute the same quantized values give the same detections.  The
port's fixed routes transform in float64 and match the golden model exactly;
the JAX package's float32 chains (its XLA chain, its bf16x6 fused kernel)
may move a quantized value by 1 LSB at a rounding boundary, so against them
a few cells at an integer threshold tie may flip on noisy frames: there the
bound of ``tests/test_frontend_fixed.py`` applies, |symmetric difference| <=
max(2, n_dets // 100).
"""

from __future__ import annotations

import numpy as np


def _entries(out: dict, keys, index=None):
    """The top-K arrays ``keys`` and ``valid`` of a processor's output as
    numpy (``index`` picks an entry of a batched output)."""
    def get(key):
        v = out[key]
        v = v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
        return v if index is None else v[index]
    return [get(k) for k in (*keys, "valid")]


def detection_set(out: dict, index=None) -> dict:
    """{(range_bin, doppler_bin): mag} of the valid top-K entries of a
    processor's output (``index`` picks a frame of a batched output)."""
    return {(int(r), int(d)): float(m) for r, d, m, ok in zip(*_entries(
        out, ("range_bin", "doppler_bin", "mag"), index)) if ok}


def map_set(det_map) -> dict:
    """{(r, d): value} of the nonzero cells of a detection map."""
    det_map = np.asarray(det_map)
    r, d = np.nonzero(det_map)
    return {(int(a), int(b)): float(det_map[a, b]) for a, b in zip(r, d)}


def _golden_found(dets, targets, shape, dr: int = 2, dd: int = 1) -> bool:
    """Every (range_bin, doppler_bins) target has a detection within
    +-dr range bins and +-dd Doppler bins (Doppler wraps)."""
    R, D = shape
    for rbin, dopp, _ in targets:
        db = int(round(dopp)) % D
        if not any(abs(r - rbin) <= dr
                   and min((d - db) % D, (db - d) % D) <= dd
                   for r, d in dets):
            return False
    return True


REL_TOL = 1e-5        # of the reference map's peak
MAX_DIFF_FRAC = 0.2   # of the larger detection set


def _set_checks(a: dict, b: dict, M, T, S, radius: int, beam_radius: int,
                capacity: int | None, tol: float) -> tuple[list, list]:
    """Checks 1-3 on sets keyed (beam, r, d) against (A, R, D) cubes;
    returns (messages, one-sided keys)."""
    A, R, D = M.shape
    msgs = []
    for key in sorted(a.keys() & b.keys()):
        if abs(a[key] - b[key]) > tol:
            msgs.append(f"common {key}: {a[key]} vs {b[key]} > tol {tol:.3g}")
    r = radius
    only = sorted(a.keys() ^ b.keys())
    edge = -np.inf
    if capacity is not None and capacity in (len(a), len(b)):
        edge = max(min(s.values()) for s in (a, b) if s) + tol
    for key in only:
        bc, rc, dc = key
        if a.get(key, b.get(key)) <= edge:
            continue
        rows = [(rc + i) % R for i in range(-r, r + 1)]
        cols = [(dc + j) % D for j in range(-r, r + 1)]
        win = np.ix_(rows, cols)
        m, t, sc = M[bc][win], T[bc][win], S[bc][win]
        mc = M[bc, rc, dc]
        at_threshold = np.any(np.abs(m - t) <= (1.0 + sc) * tol)
        beams = [bc + o for o in range(-beam_radius, beam_radius + 1)
                 if o and 0 <= bc + o < A]
        tie = (np.sum(np.abs(m - mc) <= 2.0 * tol) > 1
               or any(abs(M[bn, rc, dc] - mc) <= 2.0 * tol for bn in beams))
        if not (at_threshold or tie):
            where = key if A > 1 else key[1:]
            msgs.append(f"one-sided {where}: no decision margin "
                        f"(M={mc:.6g}, T={T[bc, rc, dc]:.6g})")
    n = max(len(a), len(b), 1)
    if len(only) > MAX_DIFF_FRAC * n:
        msgs.append(f"{len(only)} of {n} detections differ "
                    f"(> {MAX_DIFF_FRAC:.0%})")
    return msgs, only


def margin_gate(a: dict, b: dict, mag, threshold, scale, radius: int,
                targets=None, capacity: int | None = None
                ) -> tuple[bool, str]:
    """Check detection sets ``a`` and ``b`` ({(r, d): mag}) against the
    reference maps; returns (ok, report)."""
    M = np.asarray(mag, np.float64)
    R, D = M.shape
    tol = REL_TOL * float(np.max(M))
    msgs, only = _set_checks(
        {(0, *k): v for k, v in a.items()}, {(0, *k): v for k, v in b.items()},
        M[None], np.asarray(threshold, np.float64)[None],
        np.asarray(scale, np.float64)[None], radius, 0, capacity, tol)
    if targets is not None:
        for name, dets in (("a", a), ("b", b)):
            if not _golden_found(dets, targets, (R, D)):
                msgs.append(f"set {name} misses a golden target")
    report = (f"{len(a)} vs {len(b)} detections, {len(only)} one-sided, "
              f"tol {tol:.3g}")
    return not msgs, "; ".join([report] + msgs)


def array_set(out: dict, index=None) -> dict:
    """{(beam_bin, range_bin, doppler_bin): mag} of the valid top-K entries
    of an array processor's output (``index`` picks a cube of a batch)."""
    return {(int(b), int(r), int(d)): float(m) for b, r, d, m, ok in zip(
        *_entries(out, ("beam_bin", "range_bin", "doppler_bin", "mag"),
                  index)) if ok}


def array_gate(a: dict, b: dict, mag, threshold, scale, radius: int,
               beam_radius: int = 0, targets=None, target_beam=None,
               capacity: int | None = None) -> tuple[bool, str]:
    """The margin gate on array-model detection sets ``a`` and ``b``
    ({(beam, r, d): mag}) against the reference's (A, R, D) magnitude,
    threshold and scale cubes: checks 1-3 of ``margin_gate`` with the
    near-threshold test in the cell's own beam's (2r+1)^2 neighbourhood and
    a tie also allowed with the same cell of a beam within ``beam_radius``;
    the strongest detection is the same on both sides; each of ``targets``
    is found at beam ``target_beam``.  Returns (ok, report)."""
    M = np.asarray(mag, np.float64)
    A, R, D = M.shape
    tol = REL_TOL * float(np.max(M))
    msgs, only = _set_checks(a, b, M, np.asarray(threshold, np.float64),
                             np.asarray(scale, np.float64), radius,
                             beam_radius, capacity, tol)
    top = [max(s, key=s.get) if s else None for s in (a, b)]
    if top[0] != top[1]:
        msgs.append(f"strongest detections differ: {top[0]} vs {top[1]}")
    if targets is not None:
        for name, dets in (("a", a), ("b", b)):
            at_beam = [(r, d) for bb, r, d in dets if bb == target_beam]
            if not _golden_found(at_beam, targets, (R, D)):
                msgs.append(f"set {name} misses a golden target at beam "
                            f"{target_beam}")
    report = (f"{len(a)} vs {len(b)} detections, {len(only)} one-sided, "
              f"tol {tol:.3g}, strongest {top[1]}")
    return not msgs, "; ".join([report] + msgs)


def fixed_gate(a: dict, b: dict, exact: bool = True) -> tuple[bool, str]:
    """Fixed-mode detection-set check of ``a`` against ``b`` ({(r, d): mag}):
    with ``exact``, equal sets of cells; otherwise |a ^ b| <= max(2,
    n_dets // 100) with n_dets the larger set's size.  Magnitudes are
    reported (their largest difference on common cells), not checked: FFTs
    of other precision move them by a few LSB.  Returns (ok, report)."""
    sym = set(a) ^ set(b)
    n = max(len(a), len(b))
    bound = 0 if exact else max(2, n // 100)
    common = a.keys() & b.keys()
    dmag = max((abs(a[k] - b[k]) for k in common), default=0)
    report = (f"{len(a)} vs {len(b)} detections, {len(sym)} one-sided "
              f"(bound {bound}), magnitudes within {dmag:g}")
    if len(sym) > bound:
        return False, f"{report}: {sorted(sym)[:8]}"
    return True, report
