"""Build and load the CUDA kernels of ``csrc/``.

The sources are compiled on first use with ``nvcc`` for ``sm_90a`` (one
``nvcc`` process per source, all started together, then one link) into a
shared library with a plain C interface under ``build/`` beside the package,
and loaded with ``ctypes``.  The library's name carries a hash of the sources
and flags, so an edited source is rebuilt and an unchanged one is reused.
No ``--use_fast_math``: the CFAR decision relies on IEEE division and on
denormals being kept.

Nothing here runs at import time; ``load()`` is called by the kernel
wrappers (``ops/frontend.py``, ``ops/frontend_fixed.py``,
``ops/cfar_detect.py``, ``ops/cfar3d_detect.py``, ``ops/beam_group.py``,
``ops/split_frontend.py``, ``ops/cfar_rank.py``)
when they are handed a CUDA tensor.  Each wrapper is registered with
``counted`` and carries ``launches``, the number of kernels it launched
since ``reset_launch_counts()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("range_fft.cu", "slowtime_detect.cu", "range_fft_fixed.cu",
           "slowtime_detect_fixed.cu", "cfar_detect.cu", "cfar_3d_detect.cu",
           "beam_group.cu", "cfar_rank.cu")
HEADERS = ("fixed_point.cuh", "cfar_common.cuh", "cfar_tile.cuh",
           "slowtime_common.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class SlowtimeConfig(ctypes.Structure):
    """Mirror of ``struct SlowtimeConfig`` in csrc/slowtime_common.cuh."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "batch", "R", "ND", "T", "H",
        "hr", "hd", "gr", "gd", "n_ref", "k",
        "scale_min", "scale_nom", "scale_max",
        "block_mode", "sb", "n_blk", "k_blk",
        "so", "pgr", "exact_mag",
        "notch_mode", "transient_zero", "bypass", "rnd", "shift",
        "row_off", "r_total")]


class CfarDetectConfig(ctypes.Structure):
    """Mirror of ``struct CfarDetectConfig`` in csrc/cfar_detect.cu."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "batch", "R", "D", "T",
        "hr", "hd", "gr", "gd", "n_ref", "k",
        "scale_min", "scale_nom", "scale_max",
        "block_mode", "so", "integer", "prepadded",
        "strip", "packed", "pgr", "float_max", "flat", "start0", "stride")]


class CfarRankConfig(ctypes.Structure):
    """Mirror of ``struct CfarRankConfig`` in csrc/cfar_rank.cu."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "batch", "R", "D", "T",
        "hr", "hd", "gr", "gd", "n_ref", "k",
        "scale_min", "scale_nom", "scale_max",
        "block_mode", "so", "integer", "prepadded", "bits", "pgr")]


class Cfar3dConfig(ctypes.Structure):
    """Mirror of ``struct Cfar3dConfig`` in csrc/cfar_3d_detect.cu."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "batch", "A", "R", "D", "T", "ha", "ga",
        "hr", "hd", "gr", "gd", "n_ref", "k",
        "scale_min", "scale_nom", "scale_max", "so", "integer", "prepadded",
        "strip", "packed")]


class BeamGroupConfig(ctypes.Structure):
    """Mirror of ``struct BeamGroupConfig`` in csrc/beam_group.cu."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "batch", "NB", "R", "D", "radius", "halo", "id0", "n_total")]


_counted = []


def counted(fn):
    """Register a kernel wrapper: ``fn.launches`` counts the kernels it has
    launched (the wrapper adds one where it launches, nowhere else)."""
    fn.launches = 0
    _counted.append(fn)
    return fn


def reset_launch_counts() -> None:
    """Set every registered wrapper's ``launches`` to 0."""
    for fn in _counted:
        fn.launches = 0


def launch_counts() -> dict:
    """{wrapper name: launches} of every registered wrapper."""
    return {fn.__name__: fn.launches for fn in _counted}


class BuildInfo:
    """What the last build did: its library path, the seconds it took (0
    when an earlier build was reused) and the compiler's register/shared
    memory report (``-Xptxas -v``)."""

    def __init__(self):
        self.path: Path | None = None
        self.seconds = 0.0
        self.log = ""


build_info = BuildInfo()
_lib: ctypes.CDLL | None = None


def build_dir() -> Path:
    return CSRC.parent.parent / "build" / "fmcw_tpu_torch"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit (set CUDA_HOME)")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _build(out: Path) -> None:
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    objs = []
    try:
        for name in SOURCES:
            # Per-process names: concurrent first uses must not clobber
            # each other's objects; the finished library is renamed into
            # place atomically.
            obj = out.parent / f"{Path(name).stem}_{out.stem}_{os.getpid()}.o"
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(CSRC / name),
                 "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = []
        failed = []
        for name, proc in zip(SOURCES, procs):
            text, _ = proc.communicate()
            logs.append(f"--- {name}\n{text}")
            if proc.returncode != 0:
                failed.append(name)
        build_info.log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{build_info.log}")
        tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
        link = subprocess.run(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             *map(str, objs), "-o", str(tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        tmp.replace(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            obj.unlink(missing_ok=True)
    build_info.seconds = time.perf_counter() - t0


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; declare its C entry
    points.  Raises if ``nvcc`` is missing or a source does not compile."""
    global _lib
    if _lib is not None:
        return _lib
    out = build_dir() / f"libfmcw_kernels_{_digest()}.so"
    if not out.exists():
        _build(out)
    lib = ctypes.CDLL(str(out))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.fmcw_range_fft.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, vp]
    lib.fmcw_range_fft.restype = ci
    lib.fmcw_range_fft_float.argtypes = [vp] * 6 + [ci] * 3 + [vp]
    lib.fmcw_range_fft_float.restype = ci
    lib.fmcw_range_fft_blocks_per_sm.argtypes = [ci]
    lib.fmcw_range_fft_blocks_per_sm.restype = ci
    lib.fmcw_slowtime_detect.argtypes = [vp] * 9 + [
        ctypes.POINTER(SlowtimeConfig), vp]
    lib.fmcw_slowtime_detect.restype = ci
    lib.fmcw_slowtime_mag.argtypes = [vp] * 6 + [
        ctypes.POINTER(SlowtimeConfig), vp]
    lib.fmcw_slowtime_mag.restype = ci
    lib.fmcw_range_fft_fixed.argtypes = [vp] * 6 + [ci] * 5 + [vp]
    lib.fmcw_range_fft_fixed.restype = ci
    lib.fmcw_slowtime_detect_fixed.argtypes = [vp] * 9 + [
        ctypes.POINTER(SlowtimeConfig), vp]
    lib.fmcw_slowtime_detect_fixed.restype = ci
    for split in (lib.fmcw_slowtime_detect_split,
                  lib.fmcw_slowtime_detect_fixed_split):
        split.argtypes = [vp] * 13 + [ctypes.POINTER(SlowtimeConfig), vp]
        split.restype = ci
    lib.fmcw_cfar_detect.argtypes = [vp] * 4 + [
        ctypes.POINTER(CfarDetectConfig), vp]
    lib.fmcw_cfar_detect.restype = ci
    lib.fmcw_cfar_detect_group.argtypes = [vp] * 6 + [
        ctypes.POINTER(CfarDetectConfig), vp]
    lib.fmcw_cfar_detect_group.restype = ci
    lib.fmcw_cfar_detect_flat.argtypes = [vp] * 3 + [
        ctypes.POINTER(CfarDetectConfig), vp]
    lib.fmcw_cfar_detect_flat.restype = ci
    lib.fmcw_cfar_3d_detect.argtypes = [vp] * 3 + [
        ctypes.POINTER(Cfar3dConfig), vp]
    lib.fmcw_cfar_3d_detect.restype = ci
    lib.fmcw_beam_group.argtypes = [vp] * 4 + [
        ctypes.POINTER(BeamGroupConfig), vp]
    lib.fmcw_beam_group.restype = ci
    lib.fmcw_cfar_rank.argtypes = [vp] * 7 + [
        ctypes.POINTER(CfarRankConfig), vp]
    lib.fmcw_cfar_rank.restype = ci
    lib.fmcw_cfar_rank_smem.argtypes = [ctypes.POINTER(CfarRankConfig)]
    lib.fmcw_cfar_rank_smem.restype = ci
    build_info.path = out
    _lib = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
