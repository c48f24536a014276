"""A numpy model of the fixed range kernel's plan
(fmcw_tpu_torch/csrc/range_fft_fixed.cu), held bit for bit against the JAX
package's golden model and the port's plain twin on the CPU.

The kernel runs only on the card; its arithmetic and index plan are
modelled here step by step, threads and shared-memory addresses included:

* group gi (8 consecutive chirps, one bulk copy of their 32-bit I/Q words)
  is chirps 8 gi .. 8 gi + 7 of the flattened (B nd) chirp axis;
* pass 1: lane t of chirp c1 = tid >> log2 N2 loads the words t + N2 m,
  applies the Q15 window in integers (saturations summed by warp, then by
  block into the frame's count), converts to FP64 with the source's
  2^52 + 2^31 bias, runs an N1-point radix-2^2 DIF DFT (twiddles: the hex
  literals of the source, W_32^8 as a swap), then multiplies by the port's
  table ``ops/frontend_fixed._range_tables`` at tw[ka N2 + t];
* the exchange through one FP64 region per chirp and plane, column ka of
  row t at (ka + t) mod N1;
* pass 2: thread (c2 = tid mod 8, q = tid / 8) runs N2-point DFTs over t;
* the BFP peak as an integer key (|x|'s high word, its low bit set when the
  low word is not 0): per thread, lanes xor 8 and 16, one slot per warp and
  chirp, the max over warps, the scale from the key's bits (checked equal
  to fmcw::bfp_scale of the true peak);
* quantize with the source's 1.5 2^52 constant (its low word); store
  X[q + N2 j + N1 kb] straight to the range-major int16 output where nd is
  not a multiple of 16, else through the paired store: two groups' tiles
  [plane][row][8 chirps], copied out in 16-byte vectors, two lanes a row.

Arithmetic: numpy FP64 with separate multiplies and adds, where the kernel
fuses some into FMAs.  That changes values by ~1e-16 relative, and only at
bins whose true value is irrational-valued: the round-half ties that decide
bit equality occur only at the integer-valued bins (k = 0, n/4, n/2, 3n/4
of integer input), whose arithmetic is exact either way (adds, subtracts
and products with exactly 0, +-1 and +-i).  The quantize step is exact in
both (the product by 2^-s is exact, so the FMA rounds once as the add
does).  The model also asserts what the design relies on: every tile and
output element written once; each direct store instruction 4 rows x 8
consecutive chirps, each tile write 64 contiguous bytes, each copy-out
instruction 16 rows x 32 bytes; and at n = 1024 no shared-memory bank
conflict in the exchange (16 distinct 8-byte bank pairs per half-warp) or
in the copy-out's 16-byte reads.
"""

import re
from pathlib import Path

import numpy as np
import pytest

import fmcw_tpu_torch
from fmcw_tpu.golden import fixed_point as jfx
from fmcw_tpu_torch.golden import reference as tref
from fmcw_tpu_torch.models import pipeline as tpl
from fmcw_tpu_torch.ops import fft as TF, frontend as F
from fmcw_tpu_torch.ops import frontend_fixed as FX
from fmcw_tpu_torch.ops.window import window_rounding_constant

SRC = (Path(__file__).resolve().parents[1] / "fmcw_tpu_torch" / "csrc"
       / "range_fft_fixed.cu").read_text()
K_CHIRPS = 8
COEF_WIDTH = 16
SHIFT = COEF_WIDTH - 2


def _table(name):
    body = re.search(name + r"\[16\] = \{([^}]*)\}", SRC).group(1)
    return np.array([float.fromhex(v) for v in body.split(",")])


W32_RE = _table("kW32Re")
W32_IM = _table("kW32Im")
# The source's two other FP64 constants: the bias of its int -> double
# conversion and its round-half-even constant.
BIAS = float.fromhex(re.search(r"\) -\s+(0x[0-9a-fA-F.p+]+);", SRC).group(1))
RINT = float.fromhex(re.search(r"fma\(x, scale, (0x[0-9a-fA-F.p+]+)\)",
                               SRC).group(1))


def test_fp64_constants_are_twiddles64():
    """Every FP64 constant of the source: the W_32 table is
    ops/fft.twiddles64(32) bit for bit, exactly 1, 0 and -1 at the quarter
    turns; the conversion bias is 2^52 + 2^31 and the rounding constant
    1.5 2^52."""
    want = TF.twiddles64(32)[:16]
    assert np.array_equal(W32_RE, want.real)
    assert np.array_equal(W32_IM, want.imag)
    assert (W32_RE[0], W32_IM[0], W32_RE[8], W32_IM[8]) == (1.0, 0.0, 0.0,
                                                            -1.0)
    assert BIAS == 2.0 ** 52 + 2.0 ** 31 and RINT == 1.5 * 2.0 ** 52


def _rotate32(e, r, i):
    if e == 0:
        return r, i
    if e == 8:                                       # -i, a swap
        return i, -r
    c, s = W32_RE[e], W32_IM[e]
    return r * c - i * s, r * s + i * c


def _rotate32x(e, r, i):
    """rotate32x<e>: W_32^(e + 16) = -W_32^e."""
    f = e % 32
    r, i = _rotate32(f % 16, r, i)
    return (-r, -i) if f >= 16 else (r, i)


def _dft(xr, xi, n, off):
    """dif<N, N/2, kOff> on the last axis, in place: radix-2^2 stages (two
    radix-2 DIF stages at a time, twiddles W^j, W^2j, W^3j), a radix-2 stage
    last for an odd log2 N; bit-reversed result."""
    half = n // 2
    while half >= 2:
        e = 16 // half
        for blk in range(0, n, 2 * half):
            for j in range(half // 2):
                a0 = off + blk + j
                a1, a2 = a0 + half // 2, a0 + half
                a3 = a2 + half // 2
                s02r, s02i = xr[..., a0] + xr[..., a2], xi[..., a0] + xi[..., a2]
                d02r, d02i = xr[..., a0] - xr[..., a2], xi[..., a0] - xi[..., a2]
                s13r, s13i = xr[..., a1] + xr[..., a3], xi[..., a1] + xi[..., a3]
                d13r, d13i = xi[..., a1] - xi[..., a3], xr[..., a3] - xr[..., a1]
                xr[..., a0], xi[..., a0] = s02r + s13r, s02i + s13i
                xr[..., a1], xi[..., a1] = _rotate32x(
                    2 * j * e, s02r - s13r, s02i - s13i)
                xr[..., a2], xi[..., a2] = _rotate32x(
                    j * e, d02r + d13r, d02i + d13i)
                xr[..., a3], xi[..., a3] = _rotate32x(
                    3 * j * e, d02r - d13r, d02i - d13i)
        half //= 4
    if half == 1:
        for a in range(off, off + n, 2):
            dr, di = xr[..., a] - xr[..., a + 1], xi[..., a] - xi[..., a + 1]
            xr[..., a] += xr[..., a + 1]
            xi[..., a] += xi[..., a + 1]
            xr[..., a + 1], xi[..., a + 1] = dr, di


def _brev(k, bits):
    return int(format(k, f"0{bits}b")[::-1], 2) if bits else 0


def _int_to_double(v):
    """The source's conversion: the bits of 2^52 + 2^31 + v, minus BIAS."""
    lo = (v.astype(np.int64) ^ 0x80000000) & 0xFFFFFFFF
    return ((0x43300000 << 32) | lo).astype(np.uint64).view(np.float64) - BIAS


def _bfp_scale(peak):
    """fmcw::bfp_scale: 2^-s from the bits of max(peak, 1)."""
    bits = np.maximum(peak, 1.0).view(np.int64)
    cl2 = (bits >> 52) - 1023 + ((bits & ((1 << 52) - 1)) != 0)
    s = np.maximum(cl2 - 15, 0)
    return ((1023 - s) << 52).view(np.float64)


def _abs_key(x):
    """abs_key: the high word of |x|, its lowest bit set when the low word
    is not 0."""
    bits = np.ascontiguousarray(x).view(np.uint64)
    return ((bits >> 32) & 0x7FFFFFFF) | ((bits & 0xFFFFFFFF) != 0)


def _scale_from_key(key):
    """scale_from_key: 2^-s from the key's exponent and mantissa bits."""
    key = key.astype(np.int64)
    cl2 = (key >> 20) - 1023 + ((key & 0xFFFFF) != 0)
    s = np.where(key < 0x3FF00000, 0, np.maximum(cl2 - 15, 0))
    return ((1023 - s) << 52).view(np.float64)


def _quantize(x, scale):
    """The source's quantize: low word of x * scale + 1.5 2^52, clipped."""
    lo = (x * scale + RINT).view(np.int64) & 0xFFFFFFFF
    v = np.where(lo >= 1 << 31, lo - (1 << 32), lo)
    return np.clip(v, -32768, 32767)


def _w8(k):
    """W_8^k / cos(pi/4) = a + i b, k odd."""
    return (1 if k % 8 in (1, 7) else -1), (1 if k % 8 in (5, 7) else -1)


def _eighth_parts(tr, ti, m):
    """The exact parts of X[m n/8], m odd, from the class sums T_r (last
    axis, 8): (E re, E im, P re, P im) with X = E + cos(pi/4) P."""
    (a1, b1), (a3, b3) = _w8(m), _w8(3 * m)
    g = 1 if m % 4 == 1 else -1
    u1r, u1i = tr[..., 1] - tr[..., 5], ti[..., 1] - ti[..., 5]
    u3r, u3i = tr[..., 3] - tr[..., 7], ti[..., 3] - ti[..., 7]
    pr = a1 * u1r - b1 * u1i + (a3 * u3r - b3 * u3i)
    pi = a1 * u1i + b1 * u1r + (a3 * u3i + b3 * u3r)
    er = (tr[..., 0] - tr[..., 4]) + g * (ti[..., 2] - ti[..., 6])
    ei = (ti[..., 0] - ti[..., 4]) - g * (tr[..., 2] - tr[..., 6])
    return er, ei, pr, pi


def _eighth_turn_bins(xr, xi, c0r, c0i, l2):
    """eighth_turn_bins on the threads q = 0 (tid < 8): column 0's rows
    c0r/c0i (..., 8, N2) into class sums by t mod 8, then X[m n/8] = E +
    c P for m odd, at x[bit_reverse(m N2 / 8)]."""
    n2 = c0r.shape[-1]
    tr = c0r.reshape(*c0r.shape[:-1], n2 // 8, 8).sum(-2)
    ti = c0i.reshape(*c0i.shape[:-1], n2 // 8, 8).sum(-2)
    for m in (1, 3, 5, 7):
        er, ei, pr, pi = _eighth_parts(tr, ti, m)
        p = _brev(m * n2 // 8, l2)
        xr[:, :K_CHIRPS, p] = W32_RE[4] * pr + er
        xi[:, :K_CHIRPS, p] = W32_RE[4] * pi + ei


def _distinct_banks(addr, width):
    """addr (..., 32) in units of `width` bytes (8 or 16): the lanes that
    share a shared-memory wavefront (16 for 8 bytes, 8 for 16) hit
    distinct bank groups."""
    lanes = 128 // width
    slots = np.sort(np.asarray(addr).reshape(*np.shape(addr)[:-1], -1, lanes)
                    % lanes, axis=-1)
    return bool((np.diff(slots, axis=-1) > 0).all())


def _store_pairs(qr, qi, b, c0, B, n, nd, n1, n2, l2, tid, by_warp,
                 check_banks):
    """The paired store: groups 2u and 2u + 1 (16 chirps) quantize into
    tiles [plane][row][8 chirps] (the first in its input buffer, the second
    64 bytes into the exchange region), then the block copies them out in
    16-byte vectors, two lanes a row."""
    threads = len(tid)
    c2, q = tid % K_CHIRPS, tid // K_CHIRPS
    units = len(b) // 2
    tiles = np.full((units, 2, 2 * n, K_CHIRPS), -99999, np.int64)
    written = np.zeros(tiles.shape, int)
    for j in range(n1 // n2):
        for kb in range(n2):
            k = q + n2 * j + n1 * kb
            # A warp's tile write: 4 rows x 8 chirps, 64 contiguous bytes.
            at = np.sort(((k * K_CHIRPS + c2) * 2)[by_warp], axis=-1)
            assert (np.diff(at, axis=-1) == 2).all()
            p = j * n2 + _brev(kb, l2)
            for plane, x in ((0, qr), (1, qi)):
                v = x[..., p].reshape(units, 2, threads)
                tiles[:, :, plane * n + k, c2] = v
                written[:, :, plane * n + k, c2] += 1
    assert (written == 1).all()
    out = np.full((2, B, n, nd), -99999, np.int64)
    stored = np.zeros(out.shape, int)
    in_bytes = K_CHIRPS * n * 4
    for x_buf in (0, 1):                # the first group's buffer alternates
        base = (x_buf * in_bytes, 2 * in_bytes + 64)   # tile 0, tile 1
        for i in range(n1 // 2):
            v = i * threads + tid
            h, r2 = v & 1, v >> 1
            src = np.where(h == 1, base[1], base[0]) + r2 * 16
            assert not check_banks or _distinct_banks(src[by_warp] // 16, 16)
            # A warp instruction: 16 rows x 32 contiguous bytes.
            rows = (r2 % n)[by_warp]
            assert all(len(set(r)) == 16 for r in rows)
            assert ((h[by_warp].reshape(-1, 16, 2) == [0, 1]).all())
            if x_buf:
                continue
            for u in range(units):
                bu, cu = b[2 * u], c0[2 * u]
                for lane in range(threads):
                    plane, row = divmod(int(r2[lane]), n)
                    cols = slice(cu + K_CHIRPS * h[lane],
                                 cu + K_CHIRPS * (h[lane] + 1))
                    out[plane, bu, row, cols] = tiles[u, h[lane], r2[lane]]
                    stored[plane, bu, row, cols] += 1
    assert (stored == 1).all()
    return out[0], out[1]


def _store_direct(qr, qi, b, c0, B, n, nd, n1, n2, l2, tid, by_warp):
    """Each thread stores its rows straight from registers."""
    c2, q = tid % K_CHIRPS, tid // K_CHIRPS
    out = np.full((2, B, n, nd), -99999, np.int64)
    stored = np.zeros((B, n, nd), int)
    col = c0[:, None] + c2
    bb = np.broadcast_to(b[:, None], col.shape)
    for j in range(n1 // n2):
        for kb in range(n2):
            k = q + n2 * j + n1 * kb
            # Each warp instruction: 4 rows x 8 consecutive chirps.
            flat = (k * nd + c2)[by_warp]
            runs = np.sort(flat, axis=-1).reshape(-1, 4, K_CHIRPS)
            assert (np.diff(runs, axis=-1) == 1).all()
            p = j * n2 + _brev(kb, l2)
            out[0, bb, k, col] = qr[..., p]
            out[1, bb, k, col] = qi[..., p]
            np.add.at(stored, (bb, np.broadcast_to(k, col.shape), col), 1)
    assert (stored == 1).all()
    return out[0], out[1]


def kernel_model(iq, rnd, check_banks):
    """The kernel on int16 iq (B, nd, n, 2) -> int16-valued re/im (B, n, nd)
    and the saturation count (B,)."""
    B, nd, n, _ = iq.shape
    n1, n2 = F.range_fft_plan(n)
    l1, l2 = n1.bit_length() - 1, n2.bit_length() - 1
    threads = K_CHIRPS * n2
    warps = threads // 32
    region = n + (18 - n % 16) % 16
    assert region % 16 == 2
    win, tw = (x.numpy() for x in FX._range_tables(n, COEF_WIDTH, "cpu"))
    tid = np.arange(threads)
    t, c1 = tid & (n2 - 1), tid >> l2                 # pass 1
    c2, q = tid % K_CHIRPS, tid // K_CHIRPS           # pass 2
    by_warp = tid.reshape(-1, 32)
    groups = B * nd // K_CHIRPS
    gi = np.arange(groups)
    b, c0 = gi // (nd // K_CHIRPS), gi % (nd // K_CHIRPS) * K_CHIRPS
    # The bulk copy: 8 chirps of 32-bit words, I in the low half.
    words = np.ascontiguousarray(iq).view(np.uint32).reshape(groups, -1)
    # 1. Window in integers: word t + N2 m of chirp c1.
    at = c1[:, None] * n + t[:, None] + n2 * np.arange(n1)   # (threads, N1)
    w = words[:, at]
    coef = win[t[:, None] + n2 * np.arange(n1)].astype(np.int64)

    def window(x):
        v = (x.astype(np.int64) * coef + rnd) >> SHIFT
        return np.clip(v, -32768, 32767), (v > 32767) | (v < -32768)

    vi, si = window((w & 0xFFFF).astype(np.uint16).view(np.int16))
    vq, sq = window((w >> 16).astype(np.uint16).view(np.int16))
    per_warp = (si.sum(-1) + sq.sum(-1)).reshape(groups, warps, 32).sum(-1)
    sat = np.zeros(B, np.int64)
    np.add.at(sat, b, per_warp.sum(-1))
    xr, xi = _int_to_double(vi), _int_to_double(vq)
    assert np.array_equal(xr, vi) and np.array_equal(xi, vq)
    # 2. N1-point DFT, then W_n^(t ka) = tw[ka N2 + t].
    _dft(xr, xi, n1, 0)
    for ka in range(1, n1):
        p = _brev(ka, l1)
        wr, wi = tw[ka * n2 + t, 0], tw[ka * n2 + t, 1]
        xr[..., p], xi[..., p] = (xr[..., p] * wr - xi[..., p] * wi,
                                  xr[..., p] * wi + xi[..., p] * wr)
    # 3. The exchange: row t of chirp c1's region (column ka at (ka + t) mod
    #    N1), then columns q + N2 j.
    for x in (xr, xi):
        xch = np.full((groups, K_CHIRPS * region), np.nan)
        for ka in range(n1):
            put = c1 * region + t * n1 + ((ka + t) & (n1 - 1))
            assert not check_banks or _distinct_banks(put[by_warp], 8)
            xch[:, put] = x[..., _brev(ka, l1)]
        for j in range(n1 // n2):
            for tp in range(n2):
                get = c2 * region + tp * n1 + ((q + n2 * j + tp) & (n1 - 1))
                assert not check_banks or _distinct_banks(get[by_warp], 8)
                x[..., j * n2 + tp] = xch[:, get]
    assert np.isfinite(xr).all() and np.isfinite(xi).all()
    col0 = xr[:, :K_CHIRPS, :n2].copy(), xi[:, :K_CHIRPS, :n2].copy()
    assert (q[:K_CHIRPS] == 0).all()
    # 4. N2-point DFTs over t'; column 0's eighth-turn bins exactly.
    for j in range(n1 // n2):
        _dft(xr, xi, n2, j * n2)
    if n2 >= 8:
        _eighth_turn_bins(xr, xi, *col0, l2)
    # 5. BFP: the thread's peak key, lanes xor 8 and 16, then over warps.
    key = np.maximum(_abs_key(xr), _abs_key(xi)).max(-1)   # (groups, threads)
    key = key.reshape(groups, warps, 4, K_CHIRPS).max(axis=2).max(axis=1)
    peak = np.maximum(np.abs(xr), np.abs(xi)).max(-1).reshape(
        groups, warps, 4, K_CHIRPS).max(axis=(1, 2))
    assert np.array_equal(_scale_from_key(key), _bfp_scale(peak))
    scale = _scale_from_key(key)[:, c2]               # (groups, threads)
    # 6. Quantize, then store: paired where nd is a multiple of 16.
    qr, qi = _quantize(xr, scale[..., None]), _quantize(xi, scale[..., None])
    args = (qr, qi, b, c0, B, n, nd, n1, n2, l2, tid, by_warp)
    if nd % (2 * K_CHIRPS) == 0:
        re_, im_ = _store_pairs(*args, check_banks)
    else:
        re_, im_ = _store_direct(*args)
    return re_, im_, sat


def golden(iq, rounding):
    """The JAX package's golden model: window_apply then bfp_fft along the
    range axis, transposed to range-major; the saturations of I and Q
    counted separately, as the port counts them."""
    coef = jfx.hamming_coeffs(iq.shape[-2], COEF_WIDTH)
    i_w, q_w, _ = jfx.window_apply(iq[..., 0], iq[..., 1], coef, COEF_WIDTH,
                                   rounding)
    zero = np.zeros_like(iq[..., 0])
    sat = sum(jfx.window_apply(x, zero, coef, COEF_WIDTH, rounding)[2]
              .sum(axis=(1, 2)) for x in (iq[..., 0], iq[..., 1]))
    re, im = jfx.bfp_fft(i_w, q_w, axis=-1)
    return re.transpose(0, 2, 1), im.transpose(0, 2, 1), sat, (i_w, q_w)


def _full_scale(rng, B, nd, n):
    return rng.integers(-32768, 32768, (B, nd, n, 2)).astype(np.int16)


def _hot(rng, B, nd, n):
    """chip_smoke.hot_batch: the golden two-target frame x 40, clipped to
    int16, one seed per frame, so the window saturates."""
    p = fmcw_tpu_torch.RadarParams(n_range=n, n_doppler=nd)
    seed = int(rng.integers(1000))
    return np.stack([tpl.complex_to_iq(np.clip(
        np.asarray(tref.two_target_frame(p, seed=seed + i)) * 40, -32768,
        32767)) for i in range(B)])


def _bit_length(x):
    """int.bit_length of each element of an int64 array (the count of
    powers of two up to |x|)."""
    powers = np.int64(1) << np.arange(63, dtype=np.int64)
    return np.searchsorted(powers, np.abs(np.asarray(x, np.int64)),
                           side="right")


def _ties(rng, B, nd, n, rounding):
    """Noise on a DC offset (DC is each chirp's peak bin), with the central
    I sample of each chirp chosen so that the DC bin's scaled value is an
    exact half-LSB tie: DC = sum of the windowed I samples, s =
    ceil(log2(DC / 2^15)), DC mod 2^s = 2^(s - 1)."""
    iq = rng.integers(-600, 600, (B, nd, n, 2)) + np.array([20000, 0])
    iq = iq.astype(np.int16)
    coef = jfx.hamming_coeffs(n, COEF_WIDTH)
    mid = n // 2
    xs = np.arange(-32768, 32768)
    vs, _, _ = jfx.window_apply(xs, xs, np.full(xs.shape, coef[mid]),
                                COEF_WIDTH, rounding)
    for bi in range(B):
        for c in range(nd):
            i_w, _, _ = jfx.window_apply(iq[bi, c, :, 0], iq[bi, c, :, 1],
                                         coef, COEF_WIDTH, rounding)
            base = int(i_w.sum() - i_w[mid])
            dc = base + vs
            s = np.maximum(0, _bit_length(dc - 1) - 15)
            ok = (s > 0) & (dc % (1 << s) == 1 << np.maximum(s - 1, 0))
            pick = np.flatnonzero(ok)
            iq[bi, c, mid, 0] = xs[pick[np.abs(vs[pick] - i_w[mid]).argmin()]]
    return iq


def _eighth(rng, B, nd, n, rounding):
    """Small noise on a DC offset (DC is each chirp's peak bin), with the
    edge samples 4, 5 and 7 of each chirp chosen so that the sqrt(2)/2 terms
    of every eighth-turn bin cancel (the class sums of the windowed samples
    s = 1 and 5, 3 and 7 (mod 8) equal, I and Q) and the bin n/8's real part
    is an exact half-LSB tie."""
    iq = rng.integers(-60, 60, (B, nd, n, 2)) + np.array([20000, 0])
    iq = iq.astype(np.int16)
    coef = jfx.hamming_coeffs(n, COEF_WIDTH)
    xs = np.arange(-32768, 32768)

    def windowed(x):
        return jfx.window_apply(x, x, coef, COEF_WIDTH, rounding)[0]

    def reach(idx):
        return jfx.window_apply(xs, xs, np.full(xs.shape, coef[idx]),
                                COEF_WIDTH, rounding)[0]

    vs = {i: reach(i) for i in (4, 5, 7)}

    def set_sample(x, idx, want):
        ok = np.flatnonzero(vs[idx] == want)
        x[idx] = xs[ok[np.abs(xs[ok] - x[idx]).argmin()]]

    for bi in range(B):
        for c in range(nd):
            for plane in (0, 1):
                x = iq[bi, c, :, plane]
                for src, dst in ((1, 5), (3, 7)):
                    w = windowed(x)
                    cls = w.reshape(-1, 8).sum(0)
                    set_sample(x, dst, cls[src] - (cls[dst] - w[dst]))
            for _ in range(3):
                wi, wq = windowed(iq[bi, c, :, 0]), windowed(iq[bi, c, :, 1])
                ci, cq = wi.reshape(-1, 8).sum(0), wq.reshape(-1, 8).sum(0)
                er = int(ci[0] - ci[4] + cq[2] - cq[6])
                s = max(0, int(wi.sum() - 1).bit_length() - 15)
                set_sample(iq[bi, c, :, 0], 4,
                           int(wi[4]) + (er - (1 << (s - 1))) % (1 << s))
    return iq


def count_eighth_ties(i_w, q_w):
    """Half-LSB ties at the eighth-turn bins whose sqrt(2)/2 terms cancel,
    from exact integer class sums."""
    n = i_w.shape[-1]
    tr = i_w.astype(np.int64).reshape(*i_w.shape[:-1], n // 8, 8).sum(-2)
    ti = q_w.astype(np.int64).reshape(*q_w.shape[:-1], n // 8, 8).sum(-2)
    z = np.fft.fft(i_w.astype(float) + 1j * q_w.astype(float), axis=-1)
    peak = np.maximum(np.abs(z.real), np.abs(z.imag)).max(-1)
    s = np.maximum(np.ceil(np.log2(np.maximum(peak, 1.0) / 32768.0)), 0)
    s = s.astype(np.int64)
    half = np.where(s > 0, 1 << np.maximum(s - 1, 0), -1)
    ties = 0
    for m in (1, 3, 5, 7):
        er, ei, pr, pi = _eighth_parts(tr, ti, m)
        for e, p in ((er, pr), (ei, pi)):
            ties += int(((p == 0) & (s > 0) & (e % (1 << s) == half)).sum())
    return ties


def count_ties(i_w, q_w):
    """Half-LSB ties at the integer-valued bins k = 0, n/4, n/2, 3n/4,
    computed exactly in integers (X[k] = sum_s x[s] (-i)^(s k / (n/4)))."""
    x = i_w.astype(np.int64) + 1j * q_w.astype(np.int64)
    n = x.shape[-1]
    z = np.fft.fft(x.astype(np.complex128), axis=-1)
    peak = np.maximum(np.abs(z.real), np.abs(z.imag)).max(-1)
    s = np.maximum(np.ceil(np.log2(np.maximum(peak, 1.0) / 32768.0)), 0)
    s = s.astype(np.int64)
    ties = 0
    for c in range(4):
        rot = (1, -1j, -1, 1j)
        ph = np.array([rot[(c * m) % 4] for m in range(n)])
        xr = (x.real.astype(np.int64) * ph.real.astype(np.int64)
              - x.imag.astype(np.int64) * ph.imag.astype(np.int64)).sum(-1)
        xi = (x.real.astype(np.int64) * ph.imag.astype(np.int64)
              + x.imag.astype(np.int64) * ph.real.astype(np.int64)).sum(-1)
        for v in (xr, xi):
            half = np.where(s > 0, 1 << np.maximum(s - 1, 0), -1)
            ties += int(((s > 0) & (v % (1 << s) == half)).sum())
    return ties


STIMULI = {"full_scale": _full_scale, "hot": _hot, "ties": _ties,
           "eighth_ties": _eighth}
SIZES = [16, 32, 64, 128, 256, 512, 1024]


# The eighth-turn ties from n = 64, where those bins lie in pass 2's column
# 0 (N2 >= 8) and the kernel computes them exactly.
@pytest.mark.parametrize("n,stimulus", [
    (n, stim) for stim in sorted(STIMULI) for n in SIZES
    if stim != "eighth_ties" or n >= 64])
def test_plan_equals_golden_bitwise(n, stimulus):
    """The model equals the golden model and the plain twin bit for bit,
    saturation counts included, at nd 8 (one group), 40 (five groups a
    frame, batch 2; both stored from registers) and 32 (two pairs of groups,
    the paired store), both window roundings."""
    import torch
    rng = np.random.default_rng(n)
    for nd, B in ((8, 1), (40, 2), (32, 1)):
        for rounding in ("unbiased", "biased"):
            make = STIMULI[stimulus]
            iq = (make(rng, B, nd, n, rounding) if "ties" in stimulus
                  else make(rng, B, nd, n))
            rnd = window_rounding_constant(COEF_WIDTH, rounding)
            got_re, got_im, got_sat = kernel_model(
                iq, rnd, check_banks=n == 1024)
            g_re, g_im, g_sat, windowed = golden(iq, rounding)
            assert np.array_equal(got_re, g_re), (nd, rounding)
            assert np.array_equal(got_im, g_im), (nd, rounding)
            assert np.array_equal(got_sat, g_sat)
            p_re, p_im, p_sat = FX.range_fft_fixed_plain(
                torch.as_tensor(iq), COEF_WIDTH, rounding)
            assert np.array_equal(got_sat, p_sat.numpy())
            off = ((got_re != p_re.numpy()) | (got_im != p_im.numpy()))
            assert not off.any()
            if stimulus == "ties":
                assert count_ties(*windowed) >= B * nd
            if stimulus == "eighth_ties":
                assert count_eighth_ties(*windowed) >= B * nd
            if stimulus == "hot":
                assert got_sat.min() > 0


def test_range_table_layout():
    """tw[ka N2 + t] = twiddles64(n)[t ka], exact at the quarter turns; the
    window is the int32 Q15 ROM."""
    for n in (16, 32, 512, 1024):
        n1, n2 = F.range_fft_plan(n)
        win, tw = (x.numpy() for x in FX._range_tables(n, COEF_WIDTH, "cpu"))
        assert win.dtype == np.int32 and tw.dtype == np.float64
        assert np.array_equal(win, jfx.hamming_coeffs(n, COEF_WIDTH))
        ka, t = np.divmod(np.arange(n), n2)
        want = TF.twiddles64(n)[t * ka]
        assert np.array_equal(tw[:, 0], want.real)
        assert np.array_equal(tw[:, 1], want.imag)
        quarter = (4 * t * ka) % n == 0
        assert set(np.abs(tw[quarter]).ravel()) <= {0.0, 1.0}
