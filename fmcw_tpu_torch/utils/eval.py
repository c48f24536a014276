"""Detection-quality evaluation: the Pd / Pfa Monte-Carlo harness.

Port of ``fmcw_tpu/utils/eval.py``.  The reference validates its detector
statistically in its testbench ("at least 2 detections on targets, at most
3 false alarms on noise-only", rtl/src/tb_os_cfar_2d.vhd:131-155); this is
the same idea as curves: Pd against SNR and the noise-only false-alarm rate,
per CFAR variant, through the port's processors on the card (``device``,
default "cuda") or on the CPU (``device="cpu"``, the plain path).

Definitions:

* A trial frame is complex white Gaussian noise (per-component sigma, int16
  quantized) with, for Pd trials, one point target of input-domain SNR
  ``A^2 / (2 sigma^2)`` at a known fractional (range, Doppler) bin.
* Pd = the fraction of trials where any reported detection lies within
  ``tolerance`` bins (Chebyshev, wrapped) of the truth.
* Pfa = false detections per cell on noise-only frames (n_dets / cells,
  over all noise trials).

The stimuli are drawn with numpy from ``seed`` in JAX's order, so both
packages see the same frames bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..params import RadarParams


def synth_trial_frame(p: RadarParams, rng: np.random.Generator,
                      snr_db: float | None, rbin: float, dbin: float,
                      sigma: float = 64.0) -> np.ndarray:
    """One int16 I/Q trial frame (n_doppler, n_range, 2): noise, plus a
    point target at fractional bins (rbin, dbin) when ``snr_db`` is not
    None."""
    nd, nr = p.n_doppler, p.n_range
    z = rng.normal(0.0, sigma, (nd, nr)) + 1j * rng.normal(0.0, sigma,
                                                           (nd, nr))
    if snr_db is not None:
        amp = sigma * np.sqrt(2.0) * 10.0 ** (snr_db / 20.0)
        n = np.arange(nr)[None, :]
        c = np.arange(nd)[:, None]
        phase = 2j * np.pi * (rbin * n / nr + dbin * c / nd)
        z = z + amp * np.exp(phase + 2j * np.pi * rng.uniform())
    z = np.clip(np.round(z.real), -32768, 32767) + 1j * np.clip(
        np.round(z.imag), -32768, 32767)
    return np.stack([z.real, z.imag], axis=-1).astype(np.int16)


def _numpy(out: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in out.items()}


def _doppler_margin(p: RadarParams, mti_bypass: bool) -> int:
    """Doppler placement margin: the CFAR halo always; with the MTI in the
    chain also n_doppler / 8 away from the DC notch, where the 2-pulse
    canceller still attenuates by ~1 dB or more."""
    dmargin = p.cfar.halo_doppler + 1
    if not mti_bypass:
        dmargin = max(dmargin, p.n_doppler // 8)
    return dmargin


def pd_pfa(p: RadarParams, *, snr_dbs=(-35, -30, -27, -24, -21, -18),
           variants=("os", "ca", "go", "so"), trials: int = 32,
           noise_trials: int = 16, seed: int = 0, tolerance: int = 1,
           sigma: float = 64.0, mti_bypass: bool = True,
           processor_kw: dict | None = None,
           truth_doppler_offset: float = 0.0,
           range_hi_margin: int = 0, device=None) -> dict:
    """Monte-Carlo Pd(SNR) curves and noise-only Pfa per CFAR variant,
    through ``models/pipeline.make_batch_processor`` (``processor_kw``; its
    default float route is kernel B, which decides every variant, where
    kernel B's tile takes the configuration, else the staged route).

    Targets are injected at random fractional bins away from the Doppler
    notch (``mti_bypass=True`` by default so that zero-Doppler placement is
    fair too; pass False to include the MTI).  Returns ``{variant: {"pfa":
    float, "pd": {snr_db: float}}}``.

    For the hw-compat detector (``processor_kw={"cfar_geometry":
    "hw_stream"}``, OS only) pass ``truth_doppler_offset=-3`` (detections
    come back at the hardware's label coordinates, 3 flat cells behind the
    true cell; Pfa counts and is unaffected) and ``range_hi_margin``
    covering the one-shot framing's never-emitted tail (ceil(lag /
    n_doppler) + 1 range rows), so that truths lie in the emission
    window."""
    from ..models import pipeline as pl

    results = {}
    cells = p.n_range * p.n_doppler
    for variant in variants:
        pv = p.replace(cfar=dataclasses.replace(p.cfar, variant=variant))
        proc = pl.make_batch_processor(pv, include_maps=False, device=device,
                                       **(processor_kw or {}))
        rng = np.random.default_rng(seed)

        noise = np.stack([synth_trial_frame(pv, rng, None, 0, 0, sigma)
                          for _ in range(noise_trials)])
        out = _numpy(proc(noise, mti_bypass=mti_bypass))
        pfa = float(out["n_dets"].sum()) / (noise_trials * cells)

        dmargin = _doppler_margin(p, mti_bypass)
        pd_curve = {}
        for snr in snr_dbs:
            truths, batch = [], []
            for _ in range(trials):
                rbin = rng.uniform(p.cfar.halo_range + 1,
                                   p.n_range - p.cfar.halo_range - 2
                                   - range_hi_margin)
                dbin = rng.uniform(dmargin, p.n_doppler - dmargin - 1)
                truths.append((rbin, dbin))
                batch.append(synth_trial_frame(pv, rng, snr, rbin, dbin,
                                               sigma))
            out = _numpy(proc(np.stack(batch), mti_bypass=mti_bypass))
            hits = 0
            for i, (rbin, dbin) in enumerate(truths):
                v = out["valid"][i]
                if not v.any():
                    continue
                dr = np.abs(out["range_bin"][i][v] - rbin)
                dr = np.minimum(dr, p.n_range - dr)       # wrap distance
                dd = np.abs(out["doppler_bin"][i][v]
                            - (dbin + truth_doppler_offset))
                dd = np.minimum(dd, p.n_doppler - dd)
                if (np.maximum(dr, dd) <= tolerance + 0.5).any():
                    hits += 1
            pd_curve[snr] = hits / trials
        results[variant] = {"pfa": pfa, "pd": pd_curve}
    return results


def format_table(results: dict) -> str:
    """Plain-text Pd/Pfa table (one row per variant)."""
    snrs = sorted(next(iter(results.values()))["pd"])
    cols = [f"Pd@{s:+g}dB" for s in snrs]
    hdr = "variant   Pfa       " + "  ".join(cols)
    lines = [hdr, "-" * len(hdr)]
    for v, r in results.items():
        row = f"{v:8s}  {r['pfa']:.2e}  " + "  ".join(
            f"{r['pd'][s]:{len(c)}.2f}" for s, c in zip(snrs, cols))
        lines.append(row)
    return "\n".join(lines)


def synth_trial_cube(p: RadarParams, rng: np.random.Generator,
                     snr_db: float | None, bbin: float, rbin: float,
                     dbin: float, n_elems: int, n_beams: int,
                     sigma: float = 64.0, spacing_wl: float = 0.5,
                     max_angle_deg: float = 60.0) -> np.ndarray:
    """One int16 element-space trial cube (n_elems, nd, nr, 2): independent
    noise per element, plus (Pd trials) a point target whose inter-element
    phase matches the steering sine of fractional beam ``bbin`` (the
    conjugate of ``ops/beamform.steering_matrix``'s weight phase, so that
    the beamformer integrates it coherently in that beam).  ``snr_db`` is
    the per-element input SNR; beamforming adds the array gain (~10
    log10(n_elems))."""
    nd, nr = p.n_doppler, p.n_range
    z = (rng.normal(0.0, sigma, (n_elems, nd, nr))
         + 1j * rng.normal(0.0, sigma, (n_elems, nd, nr)))
    if snr_db is not None:
        amp = sigma * np.sqrt(2.0) * 10.0 ** (snr_db / 20.0)
        us = np.linspace(-np.sin(np.deg2rad(max_angle_deg)),
                         np.sin(np.deg2rad(max_angle_deg)), n_beams)
        u_t = np.interp(bbin, np.arange(n_beams), us)
        e = np.arange(n_elems)[:, None, None]
        steer = np.exp(2j * np.pi * spacing_wl * e * u_t)
        n = np.arange(nr)[None, None, :]
        c = np.arange(nd)[None, :, None]
        phase = 2j * np.pi * (rbin * n / nr + dbin * c / nd)
        z = z + amp * steer * np.exp(phase + 2j * np.pi * rng.uniform())
    z = np.clip(np.round(z.real), -32768, 32767) + 1j * np.clip(
        np.round(z.imag), -32768, 32767)
    return np.stack([z.real, z.imag], axis=-1).astype(np.int16)


def pd_pfa_3d(p: RadarParams, *, n_elems: int = 8, n_beams: int = 8,
              ref_angle: int = 1, guard_angle: int = 0,
              snr_dbs=(-35, -30, -27, -24, -21, -18),
              trials: int = 32, noise_trials: int = 16, seed: int = 0,
              tolerance: int = 1, beam_tolerance: int = 1,
              sigma: float = 64.0, mti_bypass: bool = True,
              processor_kw: dict | None = None, device=None) -> dict:
    """Pd(SNR) / Pfa of the angle-extended (3D) detector: the array model
    (``models/pipeline.make_batch_array_processor``) with ``ref_angle``
    neighbour-beam training planes.  A hit needs a detection within
    ``beam_tolerance`` beams and ``tolerance`` range / Doppler bins of the
    truth; Pfa counts per cube cell (n_beams x n_range x n_doppler).
    ``snr_dbs`` are per element.  Returns ``{p.cfar.variant: {"pfa",
    "pd"}}``."""
    from ..models import pipeline as pl

    proc = pl.make_batch_array_processor(
        p, n_elems=n_elems, n_beams=n_beams, ref_angle=ref_angle,
        guard_angle=guard_angle, include_maps=False, device=device,
        **(processor_kw or {}))
    rng = np.random.default_rng(seed)
    cells = n_beams * p.n_range * p.n_doppler

    noise = np.stack([
        synth_trial_cube(p, rng, None, 0, 0, 0, n_elems, n_beams, sigma)
        for _ in range(noise_trials)])
    out = _numpy(proc(noise, mti_bypass=mti_bypass))
    pfa = float(out["n_dets"].sum()) / (noise_trials * cells)

    bmargin = ref_angle + guard_angle
    dmargin = _doppler_margin(p, mti_bypass)
    pd_curve = {}
    for snr in snr_dbs:
        truths, batch = [], []
        for _ in range(trials):
            bbin = rng.uniform(bmargin, n_beams - 1 - bmargin)
            rbin = rng.uniform(p.cfar.halo_range + 1,
                               p.n_range - p.cfar.halo_range - 2)
            dbin = rng.uniform(dmargin, p.n_doppler - dmargin - 1)
            truths.append((bbin, rbin, dbin))
            batch.append(synth_trial_cube(p, rng, snr, bbin, rbin, dbin,
                                          n_elems, n_beams, sigma))
        out = _numpy(proc(np.stack(batch), mti_bypass=mti_bypass))
        hits = 0
        for i, (bbin, rbin, dbin) in enumerate(truths):
            v = out["valid"][i]
            if not v.any():
                continue
            db = np.abs(out["beam_bin"][i][v] - bbin)
            dr = np.abs(out["range_bin"][i][v] - rbin)
            dr = np.minimum(dr, p.n_range - dr)
            dd = np.abs(out["doppler_bin"][i][v] - dbin)
            dd = np.minimum(dd, p.n_doppler - dd)
            if ((db <= beam_tolerance + 0.5)
                    & (np.maximum(dr, dd) <= tolerance + 0.5)).any():
                hits += 1
        pd_curve[snr] = hits / trials
    return {p.cfar.variant: {"pfa": pfa, "pd": pd_curve}}
