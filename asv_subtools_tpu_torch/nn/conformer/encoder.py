"""Conformer encoder (counterpart: asv_subtools_tpu/nn/conformer/encoder.py:52-567).

``[B, T, F]`` features (+ a ``[B, T]`` mask) -> the input subsampling ->
``h * sqrt(d)`` and the position table (rel_pos) -> the blocks ->
``after_norm`` -> ``[B, T', d]`` and the subsampled mask. Channels-last
throughout; module names follow the flax modules.

Each block is the pre-norm macaron Conformer layer: half a feed-forward,
self-attention, the convolution module, half a feed-forward, then
``norm_final``. In train mode dropout draws from the caller's
``generator``, and the block's output is blended with its input by
``alpha = min(0.1 + warmup, 1)`` (JAX encoder.py:210-217, 341-343): at
warmup >= 0.9 the blend is an exact identity. ``warmup`` is a Python
number or a 0-dim tensor (the train step's, on the device).

Ported: pos_enc_type "rel_pos"; att_type "multi"; the macaron
"linear" feed-forwards with swish or relu and the convolution module;
combiner_type "norm"; block norm "layer_norm"; the conv module's
"layer_norm" or "batch_norm". Raising ``NotImplementedError``: the other
positions ("abs_pos", "rot_pos", "no_pos"), GAU, the T5 bias and the
attention norm options (attention.py), blocks without macaron or
without the conv module, layer_dropout, re_layer, re_scale, basic_norm,
the balancers, convfnn_blocks, concat_after, normalize_before=False, the
conv feed-forwards, the "mfa" and random combiners, chunk masks and the
TransformerEncoder.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..dropout import dropout
from ..norm import LayerNorm
from .attention import RelPositionMultiHeadedAttention
from .convolution import ConvolutionModule
from .mask import add_optional_chunk_mask
from .subsampling import make_subsampling

Scalar = Union[float, torch.Tensor]
_ACTIVATIONS = {"relu": torch.relu, "swish": F.silu}


def _not_ported(what: str, options: dict) -> None:
    """Raise for the first option that differs from its ported value."""
    for name, (value, ported) in options.items():
        if value != ported:
            raise NotImplementedError(f"{what} option {name}={value!r} is not ported yet")


class PositionwiseFeedForward(nn.Module):
    """Dense -> activation -> dropout -> Dense."""

    def __init__(self, dim: int, hidden_units: int = 2048, dropout_rate: float = 0.1, activation: str = "relu",
                 use_balancer: bool = False):
        super().__init__()
        _not_ported("PositionwiseFeedForward", {"use_balancer": (use_balancer, False)})
        if activation not in _ACTIVATIONS:
            raise NotImplementedError(f"activation {activation!r} is not ported yet")
        self.act, self.dropout_rate = _ACTIVATIONS[activation], dropout_rate
        self.w1 = nn.Linear(dim, hidden_units)
        self.w2 = nn.Linear(hidden_units, dim)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.act(self.w1(x))
        if self.dropout_rate > 0 and self.training:
            h = dropout(h, self.dropout_rate, generator)
        return self.w2(h)


class ConformerBlock(nn.Module):
    """One pre-norm macaron Conformer layer: 0.5 FF -> relative-position
    MHA -> conv module -> 0.5 FF -> norm_final."""

    def __init__(self, dim: int, attention_heads: int = 4, linear_units: int = 2048, dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0, pos_enc_type: str = "rel_pos", att_type: str = "multi",
                 add_t5rel_bias: bool = False, attention_norm_args: Optional[dict] = None, macaron: bool = True,
                 use_cnn: bool = True, cnn_kernel: int = 15, normalize_before: bool = True,
                 concat_after: bool = False, attention_conv_out: bool = False,
                 positionwise_layer_type: str = "linear", activation_type: str = "swish",
                 cnn_norm_type: str = "layer_norm", norm_type: str = "layer_norm", use_balancer: bool = False,
                 re_scale: bool = False, causal_conv: bool = False, convfnn: bool = False,
                 layer_dropout: float = 0.0, re_layer: bool = False):
        super().__init__()
        _not_ported("ConformerBlock", {
            "att_type": (att_type, "multi"), "add_t5rel_bias": (add_t5rel_bias, False),
            "normalize_before": (normalize_before, True), "concat_after": (concat_after, False),
            "positionwise_layer_type": (positionwise_layer_type, "linear"), "norm_type": (norm_type, "layer_norm"),
            "use_balancer": (use_balancer, False), "re_scale": (re_scale, False),
            "causal_conv": (causal_conv, False), "convfnn": (convfnn, False),
            "layer_dropout": (layer_dropout, 0.0), "re_layer": (re_layer, False), "macaron": (macaron, True),
            "use_cnn": (use_cnn, True), "pos_enc_type": (pos_enc_type, "rel_pos")})
        self.dropout_rate = dropout_rate
        ff = dict(hidden_units=linear_units, dropout_rate=dropout_rate, activation=activation_type)
        self.norm_ff_macaron = LayerNorm(dim)
        self.ff_macaron = PositionwiseFeedForward(dim, **ff)
        self.norm_mha = LayerNorm(dim)
        self.self_attn = RelPositionMultiHeadedAttention(dim, attention_heads, attention_dropout_rate,
                                                         conv_out=attention_conv_out, **(attention_norm_args or {}))
        self.norm_conv = LayerNorm(dim)
        self.conv_module = ConvolutionModule(dim, cnn_kernel, cnn_norm_type, activation=activation_type)
        self.norm_ff = LayerNorm(dim)
        self.ff = PositionwiseFeedForward(dim, **ff)
        self.norm_final = LayerNorm(dim)

    def _drop(self, h: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        if self.dropout_rate > 0 and self.training:
            return dropout(h, self.dropout_rate, generator)
        return h

    def forward(self, x: torch.Tensor, att_mask: Optional[torch.Tensor] = None,
                pad_mask: Optional[torch.Tensor] = None, warmup: Scalar = 1.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x_orig = x
        x = x + 0.5 * self._drop(self.ff_macaron(self.norm_ff_macaron(x), generator), generator)
        x = x + self._drop(self.self_attn(self.norm_mha(x), att_mask, generator), generator)
        x = x + self._drop(self.conv_module(self.norm_conv(x), pad_mask), generator)
        x = self.norm_final(x + 0.5 * self._drop(self.ff(self.norm_ff(x), generator), generator))
        if self.training:
            if isinstance(warmup, torch.Tensor):
                alpha = torch.clamp_max(0.1 + warmup, 1.0)
            else:
                alpha = min(0.1 + warmup, 1.0)
            x = alpha * x + (1.0 - alpha) * x_orig
        return x


class ConformerEncoder(nn.Module):
    """The Conformer stack: ``forward(x [B, T, F], mask [B, T])`` ->
    (``[B, T', attention_dim]``, the subsampled mask or None)."""

    def __init__(self, input_dim: int = 80, attention_dim: int = 256, attention_heads: int = 4,
                 linear_units: int = 2048, num_blocks: int = 6, dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0, layer_dropout: float = 0.0, input_layer: str = "conv2d",
                 pos_enc_type: str = "rel_pos", att_type: str = "multi", add_t5rel_bias: bool = False,
                 attention_norm_args: Optional[dict] = None, macaron: bool = True, use_cnn: bool = True,
                 cnn_kernel: int = 15, cnn_norm_type: str = "layer_norm", normalize_before: bool = True,
                 positionwise_layer_type: str = "linear", convfnn_blocks: int = 0, activation_type: str = "swish",
                 combiner_type: str = "norm", static_chunk_size: int = 0, use_dynamic_chunk: bool = False,
                 concat_after: bool = False, attention_conv_out: bool = False, re_scale: bool = False,
                 re_layer: bool = False, norm_type: str = "layer_norm", use_balancer: bool = False,
                 **unported: Any):
        super().__init__()
        if unported:
            raise NotImplementedError(f"ConformerEncoder options {sorted(unported)} are not ported yet")
        if combiner_type != "norm":
            raise NotImplementedError(f"combiner_type {combiner_type!r} is not ported yet")
        if static_chunk_size > 0 or use_dynamic_chunk:
            raise NotImplementedError("chunk masks (static_chunk_size, use_dynamic_chunk) are not ported yet")
        _not_ported("ConformerEncoder", {"convfnn_blocks": (convfnn_blocks, 0)})
        self.attention_dim = attention_dim
        self.embed = make_subsampling(input_layer, input_dim, attention_dim)
        self.blocks = []
        for i in range(num_blocks):
            block = ConformerBlock(
                attention_dim, attention_heads=attention_heads, linear_units=linear_units,
                dropout_rate=dropout_rate, attention_dropout_rate=attention_dropout_rate, pos_enc_type=pos_enc_type,
                att_type=att_type, add_t5rel_bias=add_t5rel_bias, attention_norm_args=attention_norm_args,
                macaron=macaron, use_cnn=use_cnn, cnn_kernel=cnn_kernel, normalize_before=normalize_before,
                concat_after=concat_after, attention_conv_out=attention_conv_out,
                positionwise_layer_type=positionwise_layer_type, activation_type=activation_type,
                cnn_norm_type=cnn_norm_type, norm_type=norm_type, use_balancer=use_balancer, re_scale=re_scale,
                layer_dropout=layer_dropout, re_layer=re_layer)
            self.add_module(f"block_{i}", block)
            self.blocks.append(block)
        self.after_norm = LayerNorm(attention_dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None, warmup: Scalar = 1.0,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        h, mask = self.embed(x, mask)
        # wenet's RelPositionalEncoding scales by sqrt(d); the attention
        # builds the table of positions 0..T'-1 itself
        h = h * math.sqrt(self.attention_dim)
        att_mask = add_optional_chunk_mask(mask, h.shape[1])
        for block in self.blocks:
            h = block(h, att_mask, mask, warmup, generator)
        return self.after_norm(h), mask


def TransformerEncoder(*args, **kwargs):
    raise NotImplementedError("TransformerEncoder is not ported yet")
