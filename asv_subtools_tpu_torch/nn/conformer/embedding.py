"""Sinusoidal position tables (counterpart:
asv_subtools_tpu/nn/conformer/embedding.py:18-27).

:func:`sinusoid_table` is the JAX module's numpy table. The model builds
the same table on the device with :func:`position_table` (float64 math,
rounded to float32 as the numpy table is), so a forward on the card makes
no host-to-device copy and a train step never waits on the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def sinusoid_table(length: int, dim: int) -> np.ndarray:
    """Standard transformer sin/cos table [length, dim] (float32)."""
    pos = np.arange(length, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float64) * -(math.log(10000.0) / dim))
    table = np.zeros((length, dim))
    table[:, 0::2] = np.sin(pos * div)
    table[:, 1::2] = np.cos(pos * div)
    return table.astype(np.float32)


def position_table(length: int, dim: int, device: torch.device) -> torch.Tensor:
    """:func:`sinusoid_table` computed on ``device``: [length, dim] float32."""
    pos = torch.arange(length, dtype=torch.float64, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float64, device=device) * -(math.log(10000.0) / dim))
    angle = pos * div
    return torch.stack([torch.sin(angle), torch.cos(angle)], dim=-1).reshape(length, dim).to(torch.float32)
