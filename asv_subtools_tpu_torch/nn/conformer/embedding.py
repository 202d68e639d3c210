"""Position encodings (counterpart: asv_subtools_tpu/nn/conformer/embedding.py:18-62).

:func:`sinusoid_table` is the JAX module's numpy table. The model builds
its tables on the device (float64 math rounded to float32, as the numpy
tables are), so a forward on the card makes no host-to-device copy and a
train step never waits on the card:

* :func:`position_table`: the table of positions 0..T-1 (JAX :18-27);
* :func:`abs_position_encoding`: ``x * sqrt(D) + table`` (wenet abs_pos,
  JAX :28-34);
* :func:`rel_position_encoding`: the ``[2T-1, D]`` table of positions
  T-1 .. -(T-1) (Transformer-XL, JAX :37-45);
* :func:`rope_freqs` and :func:`apply_rope`: RoPE's cos/sin tables and
  the rotation of INTERLEAVED pairs ``(x[..., 0::2], x[..., 1::2])``,
  stacked back in place (JAX :48-62), not of two halves.

A table enters the forward in the compute type; JAX's float32 tables
promote a bfloat16 forward to float32 there (the port keeps bfloat16).
"""

from __future__ import annotations

import math
from typing import Tuple

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


def _table(pos: torch.Tensor, dim: int) -> torch.Tensor:
    """sin/cos interleaved over float64 positions [P] -> [P, dim] float32."""
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float64, device=pos.device) * -(math.log(10000.0) / dim))
    angle = pos[:, None] * div
    return torch.stack([torch.sin(angle), torch.cos(angle)], dim=-1).reshape(pos.shape[0], dim).to(torch.float32)


def position_table(length: int, dim: int, device: torch.device) -> torch.Tensor:
    """:func:`sinusoid_table` computed on ``device``: [length, dim] float32."""
    return _table(torch.arange(length, dtype=torch.float64, device=device), dim)


def rel_position_encoding(t: int, dim: int, device: torch.device) -> torch.Tensor:
    """The relative table of positions t-1 .. -(t-1): [2t-1, dim] float32."""
    return _table(torch.arange(t - 1, -t, -1, dtype=torch.float64, device=device), dim)


def abs_position_encoding(x: torch.Tensor, scale: bool = True) -> torch.Tensor:
    """x [B, T, D] -> x * sqrt(D) (``scale``) + the table of positions 0..T-1."""
    t, d = x.shape[-2], x.shape[-1]
    if scale:
        x = x * math.sqrt(d)
    return x + position_table(t, d, x.device).to(x.dtype)


def rope_freqs(t: int, rot_dim: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """RoPE's (cos, sin) tables [t, rot_dim // 2] float32."""
    inv = 1.0 / (10000 ** (torch.arange(0, rot_dim, 2, dtype=torch.float64, device=device) / rot_dim))
    ang = torch.arange(t, dtype=torch.float64, device=device)[:, None] * inv[None, :]
    return torch.cos(ang).to(torch.float32), torch.sin(ang).to(torch.float32)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate the interleaved pairs of x [..., T, D] (D even) by the tables
    [T, D/2], in at least float32; the result keeps x's type."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    cos, sin = cos.to(xf.dtype), sin.to(xf.dtype)
    x1, x2 = xf[..., 0::2], xf[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.reshape(x.shape).to(x.dtype)
