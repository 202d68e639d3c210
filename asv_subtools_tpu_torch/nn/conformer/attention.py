"""Self-attention of the Conformer (counterpart:
asv_subtools_tpu/nn/conformer/attention.py:35-250).

``MultiHeadedAttention`` and ``RelPositionMultiHeadedAttention`` with a
fused ``qkv`` Dense; the scores, the softmax and the product with the
values are plain ``torch.matmul``, as the JAX package leaves them to XLA.
Masks are boolean (True = attend), ``[B, 1, T, T]`` or broadcastable.

``attention_normalize`` keeps the JAX form: scores over sqrt(Dh), masked
entries set to ``NEG_INF = -1e9`` (not -inf), the softmax, then masked
entries zeroed. A query row with every key masked (a padded frame) thus
gets a uniform softmax and then zeros, where -inf would give NaN.

Precision: the scores, the mask and the softmax run in at least float32;
the attention weights go back to the compute type for the product with
the values. The position table enters in the compute type (JAX's table is
float32, which promotes a bfloat16 forward's attention to float32).

Ported: norm_method "softmax" and the u/v-biased relative-position
attention without the Transformer-XL shift (``rel_shift=False``, the
reference's default). ``rel_shift``, ``conv_out``, ``scale_adapt``,
``g_sa``, ``diag_mask``, the norm methods "relu_plus" and "softmax_plus",
the T5 bias, RoPE and GAU raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..dropout import dropout
from ..norm import _at_least_f32
from .embedding import position_table

NEG_INF = -1.0e9


def attention_normalize(scores: torch.Tensor, mask: Optional[torch.Tensor], d_k: int) -> torch.Tensor:
    """Raw scores q.k -> attention weights (norm_method "softmax"), in the
    scores' type; masked entries are 0."""
    scores = scores / math.sqrt(d_k)
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    attn = torch.softmax(scores, dim=-1)
    if mask is not None:
        attn = attn.masked_fill(~mask, 0.0)
    return attn


def _check_options(norm_method: str = "softmax", scale_adapt: bool = False, g_sa: bool = False,
                   diag_mask: bool = False, conv_out: bool = False, train_len: float = 512.0) -> None:
    for name, value, off in (("scale_adapt", scale_adapt, False), ("g_sa", g_sa, False),
                             ("diag_mask", diag_mask, False), ("conv_out", conv_out, False)):
        if value != off:
            raise NotImplementedError(f"attention option {name} is not ported yet (ROADMAP Queue 1 item 3)")
    if norm_method != "softmax":
        raise NotImplementedError(f"attention norm_method {norm_method!r} is not ported yet (ROADMAP Queue 1 item 3)")


class MultiHeadedAttention(nn.Module):
    """Standard multi-head self-attention: x [B, T, D] -> [B, T, D]."""

    def __init__(self, dim: int, num_heads: int = 4, dropout_rate: float = 0.0, **options):
        super().__init__()
        _check_options(**options)
        if dim % num_heads:
            raise ValueError(f"dim {dim} is not a multiple of num_heads {num_heads}")
        self.num_heads, self.dropout_rate = num_heads, dropout_rate
        self.qkv = nn.Linear(dim, 3 * dim)
        self.out = nn.Linear(dim, dim)

    def _split(self, x: torch.Tensor):
        """-> q [B, T, H, Dh], k and v [B, H, T, Dh]."""
        b, t, d = x.shape
        q, k, v = self.qkv(x).view(b, t, 3, self.num_heads, d // self.num_heads).unbind(2)
        return q, k.transpose(1, 2), v.transpose(1, 2)

    def _attend(self, scores, v, mask, generator):
        """scores [B, H, T, T] at raw scale -> the output projection."""
        attn = attention_normalize(scores, mask, v.shape[-1])
        if self.dropout_rate > 0 and self.training:
            attn = dropout(attn, self.dropout_rate, generator)
        out = torch.matmul(attn.to(v.dtype), v)  # [B, H, T, Dh]
        b, h, t, dh = out.shape
        return self.out(out.transpose(1, 2).reshape(b, t, h * dh))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        q, k, v = self._split(x)
        scores = _at_least_f32(torch.matmul(q.transpose(1, 2), k.transpose(-1, -2)))
        return self._attend(scores, v, mask, generator)


class RelPositionMultiHeadedAttention(MultiHeadedAttention):
    """Relative-position attention with the u/v biases: raw scores
    ``(q + u) k^T + (q + v) p^T`` with ``p = pos(table)``, the table of the
    absolute positions 0..T-1 (no rel-shift)."""

    def __init__(self, dim: int, num_heads: int = 4, dropout_rate: float = 0.0, rel_shift: bool = False,
                 **options):
        super().__init__(dim, num_heads, dropout_rate, **options)
        if rel_shift:
            raise NotImplementedError("rel_shift=True is not ported yet (ROADMAP Queue 1 item 3)")
        dh = dim // num_heads
        self.pos = nn.Linear(dim, dim, bias=False)
        limit = math.sqrt(6.0 / (num_heads + dh))  # flax xavier_uniform over [H, Dh]
        self.pos_bias_u = nn.Parameter(torch.empty(num_heads, dh).uniform_(-limit, limit))
        self.pos_bias_v = nn.Parameter(torch.empty(num_heads, dh).uniform_(-limit, limit))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, t, d = x.shape
        q, k, v = self._split(x)
        p = self.pos(position_table(t, d, x.device).to(x.dtype))  # [T, D]
        p = p.view(t, self.num_heads, -1).transpose(0, 1)  # [H, T, Dh]
        ac = torch.matmul((q + self.pos_bias_u).transpose(1, 2), k.transpose(-1, -2))
        bd = torch.matmul((q + self.pos_bias_v).transpose(1, 2), p.transpose(-1, -2))
        return self._attend(_at_least_f32(ac) + _at_least_f32(bd), v, mask, generator)
