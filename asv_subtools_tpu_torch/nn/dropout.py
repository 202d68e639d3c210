"""Dropout drawn from an explicit generator (the train step's), and the
reference's dropout layers (counterpart: asv_subtools_tpu/nn/dropout.py;
parity: pytorch/libs/nnet/dropout.py).

The layers take [B, T, D]; ``train=False`` or a zero rate returns x
unchanged. Each splits into ``draw`` (the random tensors, from a
``torch.Generator`` on x's device, or torch's default one) and
``apply_draw`` (x and a draw -> the output), so the arithmetic can be held against JAX on
JAX's own draw: the two packages' random streams differ. Inside a mesh
step every per-row draw is made at the global batch's shape and cut to
this rank's rows (parallel/comm.py ``draw_rows``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..parallel.comm import draw_rows


def _keep_mask(shape, rate, generator: Optional[torch.Generator], device: torch.device) -> torch.Tensor:
    """True with probability 1 - rate, drawn from ``generator`` on ``device``."""
    return draw_rows(lambda s: torch.rand(s, generator=generator, device=device), shape) < 1.0 - rate


def _inverted(x: torch.Tensor, keep: torch.Tensor, keep_prob) -> torch.Tensor:
    """x / keep_prob where ``keep`` (broadcast to x), else 0."""
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout drawn from ``generator`` (on x's device): each value
    is kept with probability 1 - rate and scaled by 1 / (1 - rate)."""
    return _inverted(x, _keep_mask(x.shape, rate, generator, x.device), 1.0 - rate)


class _Layer(nn.Module):
    def active(self) -> bool:
        raise NotImplementedError

    def draw(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        raise NotImplementedError

    def apply_draw(self, x: torch.Tensor, draw) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor, train: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not train or not self.active():
            return x
        return self.apply_draw(x, self.draw(x, generator))


class Dropout(_Layer):
    """Plain inverted dropout of each value (the "default" of DROPOUTS)."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = p

    def active(self) -> bool:
        return self.p > 0.0

    def draw(self, x, generator=None) -> torch.Tensor:
        return _keep_mask(x.shape, self.p, generator, x.device)

    def apply_draw(self, x, draw) -> torch.Tensor:
        return _inverted(x, draw, 1.0 - self.p)


class ContextDropout(_Layer):
    """Drop whole frames (time steps), reference dropout.py:13-29: the
    draw is a keep mask [B, T, 1] with P(keep) = 1 - p."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        self.p = p

    def active(self) -> bool:
        return self.p > 0.0

    def draw(self, x, generator=None) -> torch.Tensor:
        return _keep_mask(x.shape[:-1] + (1,), self.p, generator, x.device)

    def apply_draw(self, x, draw) -> torch.Tensor:
        return _inverted(x, draw, 1.0 - self.p)


class RandomDropout(_Layer):
    """Dropout whose rate is drawn uniformly in [0, p] each call
    (reference dropout.py:31-79): the draw is (rate, keep mask of x's
    shape)."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = p

    def active(self) -> bool:
        return self.p > 0.0

    def draw(self, x, generator=None) -> Tuple[torch.Tensor, torch.Tensor]:
        rate = self.p * torch.rand((), generator=generator, device=x.device)
        return rate, _keep_mask(x.shape, rate, generator, x.device)

    def apply_draw(self, x, draw) -> torch.Tensor:
        rate, keep = draw
        return _inverted(x, keep, torch.clamp_min(1.0 - rate, 1e-6).to(x.dtype))


class NoiseDropout(_Layer):
    """Multiplicative noise, x * (1 + noise), with noise uniform in [-p, p]
    or gaussian of std p (reference dropout.py:81-153); the draw is the
    noise."""

    def __init__(self, p: float = 0.1, noise_type: str = "uniform"):
        super().__init__()
        if noise_type not in ("uniform", "gaussian"):
            raise ValueError(f"Unknown noise type {noise_type!r}")
        self.p = p
        self.noise_type = noise_type

    def active(self) -> bool:
        return self.p > 0.0

    def draw(self, x, generator=None) -> torch.Tensor:
        if self.noise_type == "uniform":
            return self.p * (2.0 * draw_rows(lambda s: torch.rand(s, generator=generator, device=x.device,
                                                                  dtype=x.dtype), x.shape) - 1.0)
        return self.p * draw_rows(lambda s: torch.randn(s, generator=generator, device=x.device, dtype=x.dtype),
                                  x.shape)

    def apply_draw(self, x, draw) -> torch.Tensor:
        return x * (1.0 + draw)


class SpecAugmentDropout(_Layer):
    """SpecAugment as a layer: random zero bands over the bins and the
    frames of [B, T, D] (reference dropout.py:155-234 and
    pytorch/libs/egs/augmentation.py:21). ``rows`` bands over the bins, of
    width uniform in [0, max(1, int(D * frequency))], and ``cols`` over the
    frames at ``frame``; each band starts uniformly in [0, max(1, size -
    max width)). The draw is (bin mask [B, D], frame mask [B, T]), both
    multiplicative {0, 1}."""

    def __init__(self, frequency: float = 0.2, frame: float = 0.2, rows: int = 1, cols: int = 1):
        super().__init__()
        self.frequency = frequency
        self.frame = frame
        self.rows = rows
        self.cols = cols

    def active(self) -> bool:
        return self.frequency > 0 or self.frame > 0

    @staticmethod
    def band_mask(batch_shape, size: int, max_frac: float, n_masks: int, generator, x) -> torch.Tensor:
        out = torch.ones(batch_shape + (size,), dtype=x.dtype, device=x.device)
        max_w = max(1, int(size * max_frac))
        idx = torch.arange(size, device=x.device)
        for _ in range(n_masks):
            w = draw_rows(lambda s: torch.randint(0, max_w + 1, s, generator=generator, device=x.device),
                          batch_shape)
            start = draw_rows(lambda s: torch.randint(0, max(1, size - max_w), s, generator=generator,
                                                      device=x.device), batch_shape)
            band = (idx >= start[..., None]) & (idx < (start + w)[..., None])
            out = out * (1.0 - band.to(x.dtype))
        return out

    def draw(self, x, generator=None) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        t, d = x.shape[-2], x.shape[-1]
        batch_shape = x.shape[:-2]
        fmask = self.band_mask(batch_shape, d, self.frequency, self.rows, generator, x) if self.frequency > 0 else None
        tmask = self.band_mask(batch_shape, t, self.frame, self.cols, generator, x) if self.frame > 0 else None
        return fmask, tmask

    def apply_draw(self, x, draw) -> torch.Tensor:
        fmask, tmask = draw
        if fmask is not None:
            x = x * fmask[..., None, :]
        if tmask is not None:
            x = x * tmask[..., None]
        return x


DROPOUTS = {
    "default": Dropout,
    "context": ContextDropout,
    "random": RandomDropout,
    "noise": NoiseDropout,
    "specaug": SpecAugmentDropout,
}
