"""Temporal poolings (counterpart: asv_subtools_tpu/nn/pooling.py:24-68, 486-497).

Every pooling maps frame-level features ``[B, T, D]`` (channels-last) to a
fixed vector. ``mask [B, T]`` (True = valid) makes padded batches exact.
Ported so far: the statistics pooling and its mask-free variant; the other
eight names of the JAX table are queued and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from .fused_stats_pooling import fused_stats_pooling

_EPS = 1.0e-10


def _masked_moments(x: torch.Tensor, mask: Optional[torch.Tensor], unbiased: bool = False,
                    eps: float = _EPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked mean and std over time, two-pass, in x's type.
    x [B, T, D], mask [B, T] or None. Without a mask the count is a Python
    number: a tensor made from it on the card would be a blocking copy."""
    if mask is None:
        count = float(x.shape[-2])
        mean = x.mean(dim=-2)
        var_num = ((x - mean[..., None, :]) ** 2).sum(dim=-2)
        denom = max(count - 1.0, 1.0) if unbiased else count
    else:
        m = mask.to(x.dtype)[..., None]
        count = torch.clamp_min(m.sum(dim=-2), 1.0)
        mean = (x * m).sum(dim=-2) / count
        var_num = (((x - mean[..., None, :]) ** 2) * m).sum(dim=-2)
        denom = torch.clamp_min(count - 1.0, 1.0) if unbiased else count
    std = torch.sqrt(torch.clamp_min(var_num / denom, eps))
    return mean, std


class StatisticsPooling(nn.Module):
    """Mean [+ stddev] pooling. ``fused_inference=True`` runs the pooling
    through the fused kernel (nn/fused_stats_pooling.py) in eval mode; the
    kernel computes the biased std with the mean, so it takes
    ``stddev=True, unbiased=False`` only. The default, and train mode
    always, is the unfused two-pass path: the kernel has no backward."""

    def __init__(self, stddev: bool = True, unbiased: bool = False, eps: float = _EPS,
                 fused_inference: bool = False):
        super().__init__()
        if fused_inference and (not stddev or unbiased):
            raise ValueError("the fused statistics pooling computes mean ++ biased std only "
                             "(stddev=True, unbiased=False)")
        self.stddev, self.unbiased, self.eps = stddev, unbiased, eps
        self.fused_inference = fused_inference

    def output_dim(self, input_dim: int) -> int:
        return input_dim * (2 if self.stddev else 1)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.fused_inference and not self.training:
            return fused_stats_pooling(x, mask, eps=self.eps).to(x.dtype)
        mean, std = _masked_moments(x, mask, unbiased=self.unbiased, eps=self.eps)
        return torch.cat([mean, std], dim=-1) if self.stddev else mean


class FreeStatisticsPooling(nn.Module):
    """Statistics over all frames: any mask is ignored, so padded frames
    enter the mean and std. Only for parity with reference models evaluated
    on padded batches; the masked variant is the default."""

    def __init__(self, stddev: bool = True, unbiased: bool = False, eps: float = _EPS):
        super().__init__()
        self.stddev, self.unbiased, self.eps = stddev, unbiased, eps

    def output_dim(self, input_dim: int) -> int:
        return input_dim * (2 if self.stddev else 1)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        mean, std = _masked_moments(x, None, unbiased=self.unbiased, eps=self.eps)
        return torch.cat([mean, std], dim=-1) if self.stddev else mean


def _queued(name: str) -> Callable:
    def build(*args, **kwargs):
        raise NotImplementedError(f"pooling {name!r} is not ported yet")

    return build


POOLINGS: Dict[str, Callable[..., nn.Module]] = {
    "statistics": StatisticsPooling,
    "free-statistics": FreeStatisticsPooling,
    **{name: _queued(name) for name in (
        "lde", "attentive", "multi-head", "global-multi", "multi-resolution",
        "mqmha", "mqmha-linear", "xi")},
}

