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
