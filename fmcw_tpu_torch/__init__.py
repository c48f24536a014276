"""fmcw_tpu_torch — the PyTorch/CUDA port of the FMCW radar framework.

The same chain as ``fmcw_tpu`` (Hamming-windowed range FFT per chirp, corner
turn, MTI notch, Doppler FFT, magnitude, 2D OS-CFAR, peak grouping, top-K
detections, TWS alpha-beta tracker) on an NVIDIA GPU: plain tensor code is
PyTorch, and the fused front-end kernel is two hand-written CUDA kernels
(``csrc/``, built on first use by ``kernels.py``).  The package imports
``torch`` and numpy only.

Layout:
  params    — configuration dataclasses (== the reference's VHDL generics)
  golden    — numpy pieces the port needs (window ROM, stimulus, tracker states)
  ops       — window, DFT matrices, magnitude, CFAR, top-K, and the kernel
              wrappers with their plain PyTorch twins (ops/frontend.py)
  models    — the pipeline processor and the tracker
  kernels   — builds and loads the CUDA sources
  parity    — the detection-set margin gate used by the tests and chip_smoke.py
"""

from . import params  # noqa: F401
from .params import (RadarParams, CfarParams, TrackerParams,  # noqa: F401
                     full, quick, fast)

__version__ = "0.1.0"
