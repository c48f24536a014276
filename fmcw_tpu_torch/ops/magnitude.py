"""Complex magnitude — alpha-max-beta-min approximation
(rtl/src/magnitude_calc.vhd): |Z| ~ max(|I|,|Q|) + 0.375*min(|I|,|Q|)."""

from __future__ import annotations

import torch


def magnitude_float(re: torch.Tensor, im: torch.Tensor,
                    exact: bool = False) -> torch.Tensor:
    """Float magnitude map; ``exact=True`` uses hypot(I, Q)."""
    if exact:
        return torch.hypot(re, im)
    ai, aq = re.abs(), im.abs()
    return torch.maximum(ai, aq) + 0.375 * torch.minimum(ai, aq)


def magnitude_fixed(i: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Bit-exact integer magnitude (magnitude_calc.vhd:70-88): max + min>>2 +
    min>>3, int32.  Port of ``fmcw_tpu/ops/magnitude.magnitude_fixed``."""
    ai = i.to(torch.int32).abs()
    aq = q.to(torch.int32).abs()
    mx = torch.maximum(ai, aq)
    mn = torch.minimum(ai, aq)
    return mx + (mn >> 2) + (mn >> 3)
