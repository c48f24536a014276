"""A numpy model of kernel A's plan (fmcw_tpu_torch/csrc/range_fft.cu),
held against np.fft.fft on the CPU.

The kernel runs only on the card; its index arithmetic is modelled here
step by step, threads and shared-memory addresses included, so that a wrong
index shows on the CPU:

* group gi (8 consecutive chirps, one bulk copy per plane) is chirps
  8 gi .. 8 gi + 7 of the flattened (B nd) chirp axis: frame gi // (nd / 8),
  columns from 8 (gi mod nd / 8);
* pass 1: lane t of chirp c1 = tid >> log2 N2 loads samples t + N2 m,
  windows them, runs an N1-point radix-2 DIF DFT in registers (twiddles the
  float literals of the source, checked against float64 cos/sin), then
  multiplies by the port's own table ``ops/frontend._tables`` at
  tw[ka N2 + t];
* the exchange through one padded region per chirp and plane;
* pass 2: thread (c2 = tid mod 8, q = tid / 8) runs N2-point DFTs over t for
  columns q + N2 j and stores X[q + N2 j + N1 kb] straight to the
  range-major output.

Float32 arithmetic as the kernel's (FMA as one rounding of the float64
result).  The model also asserts what the design relies on: every output
element written once, each store instruction whole 32-byte runs of 8
chirps, and — at n = 1024, the timed size — no shared-memory bank conflict
in the exchange.
"""

import re
from pathlib import Path

import numpy as np
import pytest

from fmcw_tpu_torch.ops import frontend as F
from fmcw_tpu_torch.ops.window import hamming_float

SRC = (Path(__file__).resolve().parents[1] / "fmcw_tpu_torch" / "csrc"
       / "range_fft.cu")
K_CHIRPS = 8
F32, F64 = np.float32, np.float64


def _literal_table(name):
    text = SRC.read_text()
    body = re.search(name + r"\[16\] = \{([^}]*)\}", text).group(1)
    return np.array([F32(v.strip().rstrip("f")) for v in body.split(",")],
                    dtype=F32)


W32_RE = _literal_table("kW32Re")
W32_IM = _literal_table("kW32Im")


def test_literal_twiddles_are_float64_cos_sin_rounded():
    ang = -2.0 * np.pi * np.arange(16) / 32
    assert np.array_equal(W32_RE, np.cos(ang).astype(F32))
    assert np.array_equal(W32_IM, np.sin(ang).astype(F32))


def _fma(a, b, c):
    return (a.astype(F64) * b + c).astype(F32)


def _rotate32(e, r, i):
    if e == 0:
        return r, i
    if e == 8:
        return i, -r
    c, s = W32_RE[e], W32_IM[e]
    return _fma(r, c, -(i * s)), _fma(r, s, i * c)


def _dft(xr, xi, n, off):
    """dif<N, N/2, kOff> on the last axis of float32 arrays, in place;
    bit-reversed result."""
    half = n // 2
    while half >= 1:
        for a0 in range(0, n, 2 * half):
            for j in range(half):
                a, b = off + a0 + j, off + a0 + j + half
                dr, di = xr[..., a] - xr[..., b], xi[..., a] - xi[..., b]
                xr[..., a] += xr[..., b]
                xi[..., a] += xi[..., b]
                xr[..., b], xi[..., b] = _rotate32(j * (16 // half), dr, di)
        half //= 2


def _brev(k, bits):
    return int(format(k, f"0{bits}b")[::-1], 2) if bits else 0


def _distinct_banks(addr):
    """addr (..., 32): the 32 lanes of each warp hit 32 different banks."""
    banks = np.sort(np.asarray(addr) % 32, axis=-1)
    return bool((np.diff(banks, axis=-1) > 0).all())


def kernel_model(pre, pim, win, tw, check_banks):
    """Kernel A on planes pre/pim (B, nd, n) -> (B, n, nd) re/im."""
    B, nd, n = pre.shape
    n1, n2 = F.range_fft_plan(n)
    l1, l2 = n1.bit_length() - 1, n2.bit_length() - 1
    threads = K_CHIRPS * n2
    row = n1 + 1
    region = n2 * row + (36 - n2 * row % 32) % 32
    assert region % 32 == 4
    tid = np.arange(threads)
    t, c1 = tid & (n2 - 1), tid >> l2                 # pass 1
    c2, q = tid % K_CHIRPS, tid // K_CHIRPS           # pass 2
    warps = tid.reshape(-1, 32)                       # lanes of each warp
    # The groups, as the bulk copies read them: 8 consecutive chirps.
    groups = B * nd // K_CHIRPS
    gi = np.arange(groups)
    b, c0 = gi // (nd // K_CHIRPS), gi % (nd // K_CHIRPS) * K_CHIRPS
    buf_re = pre.reshape(groups, K_CHIRPS * n)
    buf_im = pim.reshape(groups, K_CHIRPS * n)
    assert np.array_equal(buf_re[3 % groups].reshape(K_CHIRPS, n),
                          pre[b[3 % groups], c0[3 % groups]:][:K_CHIRPS])
    # 1. Loads and window: sample t + N2 m of chirp c1.
    at = c1[:, None] * n + t[:, None] + n2 * np.arange(n1)   # (threads, N1)
    s = t[:, None] + n2 * np.arange(n1)
    xr = buf_re[:, at].astype(F32) * win[s]           # (groups, threads, N1)
    xi = buf_im[:, at].astype(F32) * win[s]
    # 2. N1-point DFT, then W_n^(t ka) = tw[ka N2 + t].
    _dft(xr, xi, n1, 0)
    for ka in range(1, n1):
        p = _brev(ka, l1)
        w = tw[ka * n2 + t]                           # (threads, 2)
        r = _fma(xr[..., p], w[:, 0], -(xi[..., p] * w[:, 1]))
        xi[..., p] = _fma(xr[..., p], w[:, 1], xi[..., p] * w[:, 0])
        xr[..., p] = r
    # 3. The exchange: row t of chirp c1's region, then columns q + N2 j.
    for x in (xr, xi):
        xch = np.full((groups, K_CHIRPS * region), np.nan, F32)
        for ka in range(n1):
            put = c1 * region + t * row + ka
            assert not check_banks or _distinct_banks(put[warps])
            xch[:, put] = x[..., _brev(ka, l1)]
        for j in range(n1 // n2):
            for tp in range(n2):
                get = c2 * region + tp * row + q + n2 * j
                assert not check_banks or _distinct_banks(get[warps])
                x[..., j * n2 + tp] = xch[:, get]
    assert np.isfinite(xr).all() and np.isfinite(xi).all()
    # 4. N2-point DFTs over t', stored from registers.
    for j in range(n1 // n2):
        _dft(xr, xi, n2, j * n2)
    out_re = np.full((B, n, nd), np.nan, F32)
    out_im = out_re.copy()
    stored = np.zeros((B, n, nd), int)
    for j in range(n1 // n2):
        for kb in range(n2):
            k = q + n2 * j + n1 * kb                  # (threads,)
            col = c0[:, None] + c2                    # (groups, threads)
            # Each warp instruction: 4 rows x 8 consecutive chirps.
            flat = (k * nd + c2)[warps]
            runs = np.sort(flat, axis=-1).reshape(-1, 4, K_CHIRPS)
            assert (np.diff(runs, axis=-1) == 1).all()
            p = j * n2 + _brev(kb, l2)
            out_re[b[:, None], k, col] = xr[..., p]
            out_im[b[:, None], k, col] = xi[..., p]
            np.add.at(stored, (np.broadcast_to(b[:, None], col.shape),
                               np.broadcast_to(k, col.shape), col), 1)
    assert (stored == 1).all()
    return out_re, out_im


@pytest.mark.parametrize("n", [16, 32, 64, 128, 256, 512, 1024])
def test_plan_equals_fft(n):
    """Both entries (int16 I/Q and float planes) through the model, against
    np.fft.fft of the windowed chirps, to 1e-6 of the peak; three groups of
    8 chirps a frame in a batch of 2."""
    rng = np.random.default_rng(n)
    B, nd = 2, 24
    win, tw = (x.numpy() for x in F._tables(n, "cpu"))
    assert np.array_equal(win, hamming_float(n))
    iq = rng.integers(-2048, 2048, (B, nd, n, 2)).astype(np.int16)
    flt = rng.standard_normal((2, B, nd, n)).astype(F32) * 1000
    for pre, pim in ((iq[..., 0], iq[..., 1]), tuple(flt)):
        got_re, got_im = kernel_model(pre, pim, win, tw,
                                      check_banks=n == 1024)
        z = (pre.astype(F64) + 1j * pim.astype(F64)) * win.astype(F64)
        want = np.fft.fft(z, axis=-1).transpose(0, 2, 1)
        peak = np.abs(np.concatenate([want.real, want.imag])).max()
        err = max(np.abs(got_re - want.real).max(),
                  np.abs(got_im - want.imag).max())
        assert err <= 1e-6 * peak, (n, err / peak)


def test_table_layout():
    """tw[ka N2 + t] = W_n^(t ka): the entries the kernel reads between its
    passes."""
    for n in (16, 32, 1024):
        n1, n2 = F.range_fft_plan(n)
        assert n1 * n2 == n and n2 <= n1 <= 2 * n2 and n2 >= 4
        tw = F._tables(n, "cpu")[1].numpy()
        ka, t = np.divmod(np.arange(n), n2)
        want = np.exp(-2j * np.pi * (t * ka) / n)
        assert np.array_equal(tw[:, 0], want.real.astype(F32))
        assert np.array_equal(tw[:, 1], want.imag.astype(F32))
