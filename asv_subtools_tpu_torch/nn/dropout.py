"""Dropout drawn from an explicit generator (the train step's)."""

from __future__ import annotations

from typing import Optional

import torch


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout drawn from ``generator`` (on x's device): each value
    is kept with probability 1 - rate and scaled by 1 / (1 - rate)."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))
