"""Self-attention of the Conformer family (counterpart:
asv_subtools_tpu/nn/conformer/attention.py:27-390).

``MultiHeadedAttention`` (JAX :136-168), ``RelPositionMultiHeadedAttention``
(u/v biases, JAX :171-249), ``RoPESelfAttention`` (JAX :252-288),
``T5RelPositionBias`` (JAX :291-328) and ``GAU``, the gated attention
unit (one head on a shared base, JAX :331-390). A fused ``qkv`` Dense;
the scores, the normalisation and the product with the values are plain
``torch.matmul``, as the JAX package leaves them to XLA. Masks are
boolean (True = attend), ``[B, 1, T, T]`` or broadcastable (GAU takes
``mask[:, 0]`` of a 4-D one).

:func:`attention_normalize` keeps the JAX form (JAX :35-111): raw scores
(with the T5 bias, times sqrt(d_k), and the g_sa prior added at raw
scale) over sqrt(d_k), or times ``exp(att_scale)`` under
``scale_adapt``; masked entries set to ``NEG_INF = -1e9`` (not -inf),
the softmax, then masked entries zeroed. A query row with every key
masked (a padded frame) thus gets a uniform softmax and then zeros,
where -inf would give NaN. ``diag_mask`` masks the diagonal;
"relu_plus" is ``relu(a)**2 / len`` with masked scores 0 and len >= 1;
"softmax_plus" scales the scores by ``log(len) / train_len``, where the
leaf ``train_len`` holds log(train_len) (JAX :100-103). The learned
leaves (``att_scale``, ``g_sa_omiga``, ``g_sa_bias``, ``train_len``) sit
on the attention module, as flax puts them, and start at JAX's constants.

``conv_out`` makes the output projection ``out`` a kernel-3 "SAME"
conv1d over time (JAX :27-32). ``rel_shift=True`` aligns the relative
term Transformer-XL style over the ``[2T-1, D]`` table (JAX :191-198,
218-236); the encoder never sets it.

Precision: the scores, the mask, the normalisation and the lengths run
in at least float32; the attention weights go back to the compute type
for the product with the values. The tables enter in the compute type
(JAX's are float32, which promotes a bfloat16 forward to float32 there).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..dropout import dropout
from ..norm import _at_least_f32
from .embedding import apply_rope, position_table, rel_position_encoding, rope_freqs

NEG_INF = -1.0e9
NORM_METHODS = ("softmax", "relu_plus", "softmax_plus")


def attention_normalize(scores: torch.Tensor, mask: Optional[torch.Tensor], d_k: int, *,
                        norm_method: str = "softmax", att_scale: Optional[torch.Tensor] = None,
                        g_sa: Optional[Tuple[torch.Tensor, torch.Tensor]] = None, diag_mask: bool = False,
                        train_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Raw scores q.k [..., T1, T2] -> attention weights in the scores'
    type; masked entries are 0. ``att_scale`` (a log-scale) replaces
    1/sqrt(d_k); ``g_sa`` is (omiga, bias) of the gaussian prior;
    ``train_len`` is softmax_plus's log(train_len)."""
    t1, t2 = scores.shape[-2], scores.shape[-1]
    if g_sa is not None:
        omiga, gbias = (p.to(scores.dtype) for p in g_sa)
        qpos = torch.arange(t2 - t1, t2, device=scores.device)[:, None]
        kpos = torch.arange(t2, device=scores.device)[None, :]
        dis = ((kpos - qpos) ** 2).to(scores.dtype)
        scores = scores - torch.abs(torch.abs(dis * omiga) - torch.abs(gbias))
    if att_scale is not None:
        scores = scores * torch.exp(att_scale.to(scores.dtype))
    else:
        scores = scores / math.sqrt(d_k)
    if diag_mask:
        off_diag = ~torch.eye(t1, t2, dtype=torch.bool, device=scores.device)
        mask = off_diag if mask is None else mask & off_diag
    if norm_method == "softmax":
        if mask is not None:
            scores = scores.masked_fill(~mask, NEG_INF)
        attn = torch.softmax(scores, dim=-1)
    elif norm_method in ("relu_plus", "softmax_plus"):
        if mask is not None:
            length = torch.clamp_min(mask.sum(-1, keepdim=True).to(scores.dtype), 1.0)
        else:
            length = scores.new_full((), float(t2))
        if norm_method == "relu_plus":
            if mask is not None:
                scores = scores.masked_fill(~mask, 0.0)
            attn = torch.relu(scores) ** 2 / length
        else:
            scores = scores * (torch.log(length) / train_len.to(scores.dtype))
            if mask is not None:
                scores = scores.masked_fill(~mask, NEG_INF)
            attn = torch.softmax(scores, dim=-1)
    else:
        raise ValueError(f"unknown norm_method {norm_method!r}")
    if mask is not None:
        attn = attn.masked_fill(~mask, 0.0)
    return attn


class _Attention(nn.Module):
    """The normalisation's options and leaves, the output projection
    ``out`` (Dense, or a kernel-3 conv1d under ``conv_out``) and the
    attend step shared by the family."""

    def __init__(self, dim: int, out_in: int, d_k: int, dropout_rate: float = 0.0, conv_out: bool = False,
                 norm_method: str = "softmax", scale_adapt: bool = False, g_sa: bool = False,
                 diag_mask: bool = False, train_len: float = 512.0):
        super().__init__()
        if norm_method not in NORM_METHODS:
            raise ValueError(f"unknown norm_method {norm_method!r}")
        self.d_k, self.dropout_rate, self.conv_out = d_k, dropout_rate, conv_out
        self.norm_method, self.diag_mask, self.scale_adapt, self.g_sa = norm_method, diag_mask, scale_adapt, g_sa
        if scale_adapt:
            self.att_scale = nn.Parameter(torch.tensor(math.log(d_k ** -0.5)))
        if g_sa:
            self.g_sa_omiga = nn.Parameter(torch.tensor(0.001))
            self.g_sa_bias = nn.Parameter(torch.tensor([-0.001]))
        if norm_method == "softmax_plus":
            self.train_len = nn.Parameter(torch.tensor(math.log(train_len)))
        self.out = nn.Conv1d(out_in, dim, 3) if conv_out else nn.Linear(out_in, dim)

    def normalize(self, scores: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        return attention_normalize(
            scores, mask, self.d_k, norm_method=self.norm_method,
            att_scale=self.att_scale if self.scale_adapt else None,
            g_sa=(self.g_sa_omiga, self.g_sa_bias) if self.g_sa else None, diag_mask=self.diag_mask,
            train_len=self.train_len if self.norm_method == "softmax_plus" else None)

    def project(self, h: torch.Tensor) -> torch.Tensor:
        """``out`` over h [B, T, C]: the Dense, or the "SAME" kernel-3 conv."""
        if self.conv_out:
            return F.conv1d(h.transpose(1, 2), self.out.weight, self.out.bias, padding=1).transpose(1, 2)
        return self.out(h)

    def _attend(self, scores, v, mask, generator, extra_score=None):
        """Raw scores [B, H, T, T] (at least f32) -> the output projection."""
        if extra_score is not None:  # the T5 bias, at raw scale
            scores = scores + extra_score * math.sqrt(self.d_k)
        attn = self.normalize(scores, mask)
        if self.dropout_rate > 0 and self.training:
            attn = dropout(attn, self.dropout_rate, generator)
        out = torch.matmul(attn.to(v.dtype), v)  # [B, H, T, Dh]
        b, h, t, dh = out.shape
        return self.project(out.transpose(1, 2).reshape(b, t, h * dh))


class MultiHeadedAttention(_Attention):
    """Standard multi-head self-attention: x [B, T, D] -> [B, T, D]."""

    def __init__(self, dim: int, num_heads: int = 4, dropout_rate: float = 0.0, **options):
        if dim % num_heads:
            raise ValueError(f"dim {dim} is not a multiple of num_heads {num_heads}")
        super().__init__(dim, dim, dim // num_heads, dropout_rate, **options)
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)

    def _split(self, x: torch.Tensor):
        """-> q [B, T, H, Dh], k and v [B, H, T, Dh]."""
        b, t, d = x.shape
        q, k, v = self.qkv(x).view(b, t, 3, self.num_heads, d // self.num_heads).unbind(2)
        return q, k.transpose(1, 2), v.transpose(1, 2)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                extra_score: Optional[torch.Tensor] = None) -> torch.Tensor:
        q, k, v = self._split(x)
        scores = _at_least_f32(torch.matmul(q.transpose(1, 2), k.transpose(-1, -2)))
        return self._attend(scores, v, mask, generator, extra_score)


class RelPositionMultiHeadedAttention(MultiHeadedAttention):
    """Relative-position attention with the u/v biases: raw scores
    ``(q + u) k^T + (q + v) p^T`` with ``p = pos(table)``: the table of
    the absolute positions 0..T-1 (no rel-shift, the reference's default),
    or under ``rel_shift`` the ``[2T-1]`` relative table, shifted."""

    def __init__(self, dim: int, num_heads: int = 4, dropout_rate: float = 0.0, rel_shift: bool = False,
                 **options):
        super().__init__(dim, num_heads, dropout_rate, **options)
        self.rel_shift = rel_shift
        dh = dim // num_heads
        self.pos = nn.Linear(dim, dim, bias=False)
        limit = math.sqrt(6.0 / (num_heads + dh))  # flax xavier_uniform over [H, Dh]
        self.pos_bias_u = nn.Parameter(torch.empty(num_heads, dh).uniform_(-limit, limit))
        self.pos_bias_v = nn.Parameter(torch.empty(num_heads, dh).uniform_(-limit, limit))

    @staticmethod
    def _shift(x: torch.Tensor) -> torch.Tensor:
        """[B, H, T, 2T-1] -> [B, H, T, T]: out[q, k] = x[q, (T-1)-(q-k)]."""
        b, h, t, _ = x.shape
        x = F.pad(x, (1, 0)).reshape(b, h, 2 * t, t)[:, :, 1:, :]
        return x.reshape(b, h, t, 2 * t - 1)[..., :t]

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                extra_score: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, d = x.shape
        q, k, v = self._split(x)
        table = rel_position_encoding(t, d, x.device) if self.rel_shift else position_table(t, d, x.device)
        p = self.pos(table.to(x.dtype))  # [P, D]
        p = p.view(-1, self.num_heads, d // self.num_heads).transpose(0, 1)  # [H, P, Dh]
        ac = torch.matmul((q + self.pos_bias_u).transpose(1, 2), k.transpose(-1, -2))
        bd = _at_least_f32(torch.matmul((q + self.pos_bias_v).transpose(1, 2), p.transpose(-1, -2)))
        if self.rel_shift:
            bd = self._shift(bd)
        return self._attend(_at_least_f32(ac) + bd, v, mask, generator, extra_score)


class RoPESelfAttention(MultiHeadedAttention):
    """Rotary-position self-attention: q and k (and v under
    ``rotary_value``) rotated by RoPE over each head's Dh. JAX's module
    takes no ``extra_score``; this one adds a T5 bias when given one."""

    def __init__(self, dim: int, num_heads: int = 4, dropout_rate: float = 0.0, rotary_value: bool = True,
                 **options):
        super().__init__(dim, num_heads, dropout_rate, **options)
        self.rotary_value = rotary_value

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                extra_score: Optional[torch.Tensor] = None) -> torch.Tensor:
        q, k, v = self._split(x)
        q = q.transpose(1, 2)
        cos, sin = rope_freqs(x.shape[1], q.shape[-1], x.device)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        if self.rotary_value:
            v = apply_rope(v, cos, sin)
        scores = _at_least_f32(torch.matmul(q, k.transpose(-1, -2)))
        return self._attend(scores, v, mask, generator, extra_score)


class T5RelPositionBias(nn.Module):
    """The bucketed learned relative-position bias: ``forward(t, device)``
    -> [1, 1, T, T] in rel_bias's type. One per layer (not shared)."""

    def __init__(self, num_buckets: int = 32, max_distance: int = 128, scale: float = 1.0):
        super().__init__()
        self.num_buckets, self.max_distance, self.scale = num_buckets, max_distance, scale
        self.rel_bias = nn.Parameter(torch.randn(num_buckets, 1) * 0.02)

    def buckets(self, t: int, device: torch.device) -> torch.Tensor:
        """[T, T] int64 bucket of key k for query q (JAX :298-317): n = q - k;
        future keys (n < 0) take the upper half; |n| linear below
        num_buckets // 4, logarithmic up to max_distance, computed in
        float32 and truncated, as JAX does."""
        half = self.num_buckets // 2
        pos = torch.arange(t, device=device)
        n = pos[:, None] - pos[None, :]
        ret = torch.where(n < 0, half, 0)
        n = n.abs()
        max_exact = half // 2
        large = max_exact + (torch.log(torch.clamp_min(n, 1).to(torch.float32) / max_exact)
                             / math.log(self.max_distance / max_exact) * (half - max_exact)).to(torch.int32)
        large = torch.clamp_max(large, half - 1)
        return ret + torch.where(n < max_exact, n, large.to(n.dtype))

    def forward(self, t: int, device: torch.device) -> torch.Tensor:
        bias = self.rel_bias[self.buckets(t, device), 0]
        return (bias * self.scale)[None, None]


class GAU(_Attention):
    """Gated attention unit (FLASH): x [B, T, D] -> ``uv`` Dense to 2E + S,
    silu, split into u [E], v [E] and the shared base [S]; q and k are the
    base scaled and shifted by ``gamma`` and ``beta`` [2, S] (and rotated
    by RoPE over S under ``use_rope``); one head of scores at d_k = S;
    out = ``out``(u * (attn @ v))."""

    def __init__(self, dim: int, expansion_units: int = 512, key_dim: int = 64, dropout_rate: float = 0.0,
                 use_rope: bool = True, **options):
        super().__init__(dim, expansion_units, key_dim, dropout_rate, **options)
        self.e, self.s, self.use_rope = expansion_units, key_dim, use_rope
        self.uv = nn.Linear(dim, 2 * expansion_units + key_dim)
        self.gamma = nn.Parameter(torch.randn(2, key_dim) * 0.02)
        self.beta = nn.Parameter(torch.zeros(2, key_dim))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                extra_score: Optional[torch.Tensor] = None) -> torch.Tensor:
        u, v, base = torch.split(F.silu(self.uv(x)), [self.e, self.e, self.s], dim=-1)
        q = base * self.gamma[0] + self.beta[0]
        k = base * self.gamma[1] + self.beta[1]
        if self.use_rope:
            cos, sin = rope_freqs(x.shape[1], self.s, x.device)
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        scores = _at_least_f32(torch.matmul(q, k.transpose(-1, -2)))  # [B, T, T]
        if extra_score is not None:
            ex = extra_score[:, 0] if extra_score.dim() == 4 else extra_score
            scores = scores + ex * math.sqrt(self.s)
        if mask is not None and mask.dim() == 4:
            mask = mask[:, 0]
        attn = self.normalize(scores, mask)
        if self.dropout_rate > 0 and self.training:
            attn = dropout(attn, self.dropout_rate, generator)
        return self.project(u * torch.matmul(attn.to(v.dtype), v))
