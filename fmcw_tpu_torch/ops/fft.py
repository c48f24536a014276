"""DFT and slow-time operator matrices (numpy), their plain PyTorch
application, and the block-floating-point quantizer of the fixed chain.

The float32 chain's matrices are built exactly as ``fmcw_tpu/ops/fft.py``
builds them (float64, then float32), so the port's constants are
bit-identical to the JAX package's.  ``dft_apply`` / ``doppler_apply`` are the
plain versions of its transforms: the kernels' twins use them, and so do the
staged chains (``frontend="staged"``), which JAX too leaves to plain matrix
products.  Every float32 product runs in true float32 whatever the caller's
TF32 or ``set_float32_matmul_precision`` setting (``full_fp32``).

The fixed chain transforms in float64 (``dft64_apply``): its range DFT
reaches ~3e7, where a float32 ulp is 2, so float32 transforms move quantized
values by 1 LSB wherever a value lies near a rounding boundary, and a noisy
frame's detection set with them.  In float64, with the twiddles exact at the
quarter turns (``twiddles64``), the quantized values equal the float64 golden
model's (``golden.fixed_point.bfp_fft``), and the fused kernels, which use
the same twiddle table, equal both.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from .window import hamming_float


@contextlib.contextmanager
def full_fp32():
    """Run float32 matrix products in IEEE float32 inside the block (no TF32
    on the card, no bf16 passes on the CPU), restoring the caller's
    per-backend settings afterwards.  Reads and sets the per-backend
    ``fp32_precision`` knobs only: the legacy global getter raises for some
    mixes of the legacy setters."""
    knobs = (torch.backends.cuda.matmul, torch.backends.mkldnn.matmul)
    saved = [k.fp32_precision for k in knobs]
    for k in knobs:
        k.fp32_precision = "ieee"
    try:
        yield
    finally:
        for k, v in zip(knobs, saved):
            k.fp32_precision = v


@functools.lru_cache(maxsize=16)
def dft_matrices(n: int, window: bool = False, coef_width: int = 16):
    """(cos, -sin) DFT matrices C[s, k] = exp(-2j*pi*s*k/n), optionally
    pre-multiplied (in float64) by the Q15 Hamming window along the sample
    axis, as ``fmcw_tpu/ops/fft.dft_matrices`` folds it."""
    s = np.arange(n)[:, None].astype(np.float64)
    k = np.arange(n)[None, :].astype(np.float64)
    ang = -2.0 * np.pi * s * k / n
    cr, ci = np.cos(ang), np.sin(ang)
    if window:
        w = hamming_float(n, coef_width).astype(np.float64)[:, None]
        cr, ci = cr * w, ci * w
    return cr.astype(np.float32), ci.astype(np.float32)


@functools.lru_cache(maxsize=16)
def doppler_matrices(n: int, notch_mode: int = 2, transient: str = "zero",
                     coef_width: int = 16):
    """The whole slow-time chain folded into one matrix pair.

    Window multiply, MTI notch and Doppler DFT are all linear along the
    chirp axis, so they compose into ``M = H^T @ diag(w) @ E`` with
    ``E[s, k] = exp(-2j*pi*s*k/n)``, ``w`` the Q15 Hamming window and ``H``
    the pulse canceller (doppler_notch.vhd:72-94: y[s] = x[s] - x[s-1] or
    x[s] - 2x[s-1] + x[s-2]; missing history reads as 0 = the "passthrough"
    transient, and ``transient="zero"`` zeroes the first notch_mode-1 output
    rows instead).  Contracting the chirp axis of the range-FFT output with
    M applies all three stages.  Returns (Mr_mti, Mi_mti, Mr_plain,
    Mi_plain); the plain pair folds only the window, for ``mti_bypass``.
    """
    if notch_mode not in (2, 3):
        raise ValueError(f"notch_mode must be 2 or 3, got {notch_mode}")
    if transient not in ("zero", "passthrough"):
        raise ValueError(f"transient must be 'zero' or 'passthrough', "
                         f"got {transient!r}")
    s = np.arange(n)[:, None].astype(np.float64)
    k = np.arange(n)[None, :].astype(np.float64)
    ang = -2.0 * np.pi * s * k / n
    er, ei = np.cos(ang), np.sin(ang)
    w = hamming_float(n, coef_width).astype(np.float64)[:, None]
    er_w, ei_w = er * w, ei * w                      # diag(w) @ E
    h = np.zeros((n, n))
    for r in range(n):
        h[r, r] = 1.0
        if r >= 1:
            h[r, r - 1] = -1.0 if notch_mode == 2 else -2.0
        if notch_mode == 3 and r >= 2:
            h[r, r - 2] = 1.0
    if transient == "zero":
        h[: notch_mode - 1, :] = 0.0
    return (np.ascontiguousarray((h.T @ er_w).astype(np.float32)),
            np.ascontiguousarray((h.T @ ei_w).astype(np.float32)),
            np.ascontiguousarray(er_w.astype(np.float32)),
            np.ascontiguousarray(ei_w.astype(np.float32)))


def _cmatmul(xr, xi, cr, ci):
    """(xr + i xi) @ (cr + i ci) as four real float32 matrix products."""
    with full_fp32():
        return xr @ cr - xi @ ci, xr @ ci + xi @ cr


def dft_apply(re: torch.Tensor, im: torch.Tensor, window: bool = False):
    """Forward DFT along the LAST axis of a complex tensor given as a float32
    (re, im) pair; ``window`` folds the Hamming window into the matrix."""
    cr, ci = dft_matrices(re.shape[-1], window)
    cr = torch.as_tensor(cr, device=re.device)
    ci = torch.as_tensor(ci, device=re.device)
    return _cmatmul(re, im, cr, ci)


def doppler_apply(re: torch.Tensor, im: torch.Tensor, bypass: bool,
                  notch_mode: int = 2, transient: str = "zero"):
    """Fused slow-time stage (window + MTI + Doppler DFT) along the LAST
    axis, the chirp axis of the range-major ``(..., n_range, n_doppler)``
    layout; ``bypass`` selects the window-only matrix (``mti_bypass``)."""
    mr1, mi1, mr0, mi0 = doppler_matrices(re.shape[-1], notch_mode, transient)
    mr, mi = (mr0, mi0) if bypass else (mr1, mi1)
    return _cmatmul(re, im, torch.as_tensor(mr, device=re.device),
                    torch.as_tensor(mi, device=re.device))


def twiddles64(n: int) -> np.ndarray:
    """tw[m] = exp(-2j*pi*m/n), float64 complex, exact (0, +-1) at the
    quarter turns: the rounded cos/sin of a multiple of pi/2 would leave a
    1e-16 residue that breaks the exact round-half ties of integer-valued
    bins (DC, Nyquist) in float64."""
    m = np.arange(n)
    ang = -2.0 * np.pi * m / n
    tw = np.cos(ang) + 1j * np.sin(ang)
    quarter = (4 * m) % n == 0
    tw[quarter] = np.round(tw[quarter].real) + 1j * np.round(tw[quarter].imag)
    return tw


@functools.lru_cache(maxsize=16)
def dft64_matrices(n: int, device: str = "cpu"):
    """float64 (cos, -sin) DFT matrices C[s, k] = tw[s*k mod n] on
    ``device``."""
    s = np.arange(n)[:, None]
    k = np.arange(n)[None, :]
    c = twiddles64(n)[(s * k) % n]
    return (torch.as_tensor(np.ascontiguousarray(c.real), device=device),
            torch.as_tensor(np.ascontiguousarray(c.imag), device=device))


def _w8(k: int):
    """W_8^k / cos(pi/4) = a + i b for k odd."""
    return (1 if k % 8 in (1, 7) else -1), (1 if k % 8 in (5, 7) else -1)


def _eighth_turn_bins(re: torch.Tensor, im: torch.Tensor, yr: torch.Tensor,
                      yi: torch.Tensor) -> None:
    """Overwrite the eighth-turn bins X[m n/8], m odd, of the DFT (yr, yi)
    of integer-valued float64 (re, im) with their exact form, in place.

    With T_r the input summed over s = r (mod 8) and u_r = T_r - T_(r+4),
    X[m n/8] = u_0 + (-i)^m u_2 + W_8^m u_1 + W_8^(3m) u_3; both W_8 terms
    are cos(pi/4) (+-1 +-i), so X = E + cos(pi/4) P with E and P exact sums
    of integers.  Where P = 0 the bin is the integer E, as in the golden
    model (``np.fft.fft``), and a round-half tie there falls the same way;
    the dense product's separately rounded sqrt(2)/2 terms need not cancel.
    The fixed kernels compute these bins the same way
    (csrc/range_fft_fixed.cu ``eighth_turn_bins``, csrc/slowtime_detect_
    fixed.cu ``eighth_bin``)."""
    n = re.shape[-1]
    if n < 8 or n % 8:
        return
    tr = re.reshape(*re.shape[:-1], n // 8, 8).sum(-2)
    ti = im.reshape(*im.shape[:-1], n // 8, 8).sum(-2)
    c = float(twiddles64(8)[1].real)
    u1r, u1i = tr[..., 1] - tr[..., 5], ti[..., 1] - ti[..., 5]
    u3r, u3i = tr[..., 3] - tr[..., 7], ti[..., 3] - ti[..., 7]
    for m in (1, 3, 5, 7):
        (a1, b1), (a3, b3) = _w8(m), _w8(3 * m)
        g = 1 if m % 4 == 1 else -1
        pr = a1 * u1r - b1 * u1i + (a3 * u3r - b3 * u3i)
        pi = a1 * u1i + b1 * u1r + (a3 * u3i + b3 * u3r)
        er = (tr[..., 0] - tr[..., 4]) + g * (ti[..., 2] - ti[..., 6])
        ei = (ti[..., 0] - ti[..., 4]) - g * (tr[..., 2] - tr[..., 6])
        yr[..., m * n // 8] = er + c * pr
        yi[..., m * n // 8] = ei + c * pi


def dft64_apply(re: torch.Tensor, im: torch.Tensor):
    """Forward DFT along the LAST axis in float64: the fixed chain's plain
    transform (the inputs are integer-valued; float64 (re, im) out).  A
    dense product, with the eighth-turn bins summed exactly
    (``_eighth_turn_bins``)."""
    cr, ci = dft64_matrices(re.shape[-1], str(re.device))
    re, im = re.to(torch.float64), im.to(torch.float64)
    yr, yi = re @ cr - im @ ci, re @ ci + im @ cr
    _eighth_turn_bins(re, im, yr, yi)
    return yr, yi


def bfp_exponent(peak: torch.Tensor) -> torch.Tensor:
    """Block exponent s = max(0, ceil(log2(max(peak, 1) / 2^15))) of float32
    or float64 peaks, read exactly from the float bits (as
    ``fmcw_tpu/ops/frontend_pallas._bfp_scale``): for p >= 1, ceil(log2 p) =
    unbiased exponent + (mantissa != 0).  int32 (float32) or int64."""
    if peak.dtype == torch.float64:
        bits = torch.clamp(peak, min=1.0).view(torch.int64)
        cl2 = (bits >> 52) - 1023 + ((bits & ((1 << 52) - 1)) != 0).long()
    else:
        bits = torch.clamp(peak.to(torch.float32), min=1.0).view(torch.int32)
        cl2 = (bits >> 23) - 127 + ((bits & 0x7FFFFF) != 0).to(torch.int32)
    return torch.clamp(cl2 - 15, min=0)


def bfp_quantize(re: torch.Tensor, im: torch.Tensor, dim: int = -1):
    """Per-transform block-floating-point quantization to int16 range
    (port of ``fmcw_tpu/ops/fft.bfp_quantize``; semantics of
    ``golden.fixed_point.bfp_fft``): scale each slice along ``dim`` by 2^-s
    so its peak |component| lands in the top octave of int16, round half to
    even, clip to int16, discard the exponent.  float32 or float64 in;
    tensors of that type holding integers out.  The exponent comes from the
    float bits (``bfp_exponent``), not from a log2, which rounds peaks just
    above a power of two down (jnp.log2 in JAX's float32 chain does for
    2^(15+k)*(1+2^-23), k >= 3)."""
    peak = torch.maximum(re.abs(), im.abs()).amax(dim=dim, keepdim=True)
    s = bfp_exponent(peak)
    if re.dtype == torch.float64:
        scale = ((1023 - s) << 52).view(torch.float64)
    else:
        scale = ((127 - s) << 23).view(torch.float32)

    def q(x):
        return torch.round(x * scale).clamp(-32768.0, 32767.0)

    return q(re), q(im)
