"""The device an entry point of the port runs on: CUDA unless the caller
names another."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device, None meaning "cuda".  Raises when CUDA
    is asked for (or implied) and there is none; accepts "cuda" and "cpu"
    devices only."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fmcw_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' for the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
