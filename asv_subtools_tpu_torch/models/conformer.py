"""Conformer x-vector (counterpart: asv_subtools_tpu/models/conformer.py:21-114).

The Conformer encoder -> ``transform_out`` (Dense to 1536, swish,
LayerNorm) -> attentive statistics pooling (ECAPA's, with LayerNorm and
no time attention) on the subsampled mask -> ``bn_stats`` (a LayerNorm)
-> ``fc2`` (Dense, relu, LayerNorm). The voxceleb recipe's configuration
is 6L-256D-4H with conv2d (4x) or conv2d2 (2x) subsampling. Channels-last
throughout; module and parameter names follow the flax modules, so
weights.py maps a JAX variable tree onto this state_dict by rule.

``transformer_type`` "conformer", "transformer" (the TransformerEncoder,
JAX models/conformer.py:67-70: no macaron, no conv module, relu; the
model's own ``pos_enc_type`` overrides the encoder's "abs_pos" default,
as JAX's model passes it) or "re_conformer" (the ReConformer, JAX
models/conformer.py:55-66: BasicNorm block norms, normalize_before
False, balancers, double_swish and the re_layer blocks by default,
``encoder_params`` over them; recipes/configs/reconformer.yaml pairs it
with the "re_conv2d" subsampling). Every encoder option (nn/conformer)
goes through ``encoder_params``; an "mfa" combiner widens
``transform_out_affine``'s input to the taps' width. Any pooling of the
zoo (nn/pooling.py) may stand in for the attentive one.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..nn.conformer import ConformerEncoder, TransformerEncoder
from ..nn.norm import LayerNorm
from ..nn.pooling import build_pooling
from .ecapa import EcapaAttentiveStatsPool


# the ReConformer's encoder defaults (JAX models/conformer.py:57-66)
RE_CONFORMER = {"norm_type": "basic_norm", "normalize_before": False, "use_balancer": True,
                "activation_type": "double_swish", "positionwise_conv_kernel_size": 3, "re_layer": True}


class ConformerXvector(nn.Module):
    """Conformer speaker embedding model: x [B, T, F] (+ mask [B, T]) ->
    [B, embd_dim]. ``position`` "near" (after relu and ``fc2_norm``, the
    default) or "near_affine" (``fc2_affine``'s output).

    Built on ``device`` (the CUDA card unless ``device="cpu"``; raises
    without a card), in eval mode. Cast with ``.to(torch.bfloat16)`` for
    serving; training runs it in train mode (train/trainer.py), with
    dropout from the step's generator and the blocks' warm-up blend.
    ``encoder_params`` holds further ConformerEncoder options.
    """

    def __init__(
        self,
        input_dim: int = 80,
        embd_dim: int = 256,
        attention_dim: int = 256,
        attention_heads: int = 4,
        linear_units: int = 2048,
        num_blocks: int = 6,
        input_layer: str = "conv2d",
        pos_enc_type: str = "rel_pos",
        att_type: str = "multi",
        transformer_type: str = "conformer",
        out_dim: int = 1536,
        pooling: str = "ecpa-attentive",
        pooling_params: Optional[dict] = None,
        dropout_rate: float = 0.1,
        combiner_type: str = "norm",
        encoder_params: Optional[dict] = None,
        device: Any = None,
    ):
        super().__init__()
        if transformer_type not in ("conformer", "transformer", "re_conformer"):
            raise ValueError(f"unknown transformer_type {transformer_type!r}")
        self.embd_dim = embd_dim
        encoder = TransformerEncoder if transformer_type == "transformer" else ConformerEncoder
        self.transformer = encoder(
            input_dim, attention_dim=attention_dim, attention_heads=attention_heads, linear_units=linear_units,
            num_blocks=num_blocks, dropout_rate=dropout_rate, input_layer=input_layer, pos_enc_type=pos_enc_type,
            att_type=att_type, combiner_type=combiner_type,
            **{**(RE_CONFORMER if transformer_type == "re_conformer" else {}), **(encoder_params or {})})
        self.transform_out_affine = nn.Linear(self.transformer.output_dim, out_dim)
        self.transform_out_norm = LayerNorm(out_dim)
        pp = dict(pooling_params or {})
        if pooling == "ecpa-attentive":
            self.stats = EcapaAttentiveStatsPool(out_dim, bottleneck=pp.get("hidden_size", 128),
                                                 time_attention=pp.get("time_attention", False),
                                                 norm_type=pp.get("norm_type", "layer_norm"))
            stats_dim = 2 * out_dim
        else:
            self.stats = build_pooling(pooling, out_dim, pp)
            stats_dim = self.stats.output_dim(out_dim)
        self.bn_stats = LayerNorm(stats_dim)
        self.fc2_affine = nn.Linear(stats_dim, embd_dim)
        self.fc2_norm = LayerNorm(embd_dim)
        self.eval()
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None, position: str = "near",
                warmup: Union[float, torch.Tensor] = 1.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x [B, T, F] (channels-last), mask [B, T] -> embedding [B, embd_dim].
        ``warmup`` and ``generator`` act in train mode only."""
        if position not in ("near", "near_affine"):
            raise ValueError(f"position must be near or near_affine, got {position!r}")
        h, sub_mask = self.transformer(x, mask, warmup, generator)
        h = self.transform_out_norm(F.silu(self.transform_out_affine(h)))
        z = self.fc2_affine(self.bn_stats(self.stats(h, sub_mask)))
        if position == "near_affine":
            return z
        return self.fc2_norm(torch.relu(z))
