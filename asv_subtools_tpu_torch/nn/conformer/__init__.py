"""The Conformer family's encoder stack (counterpart: asv_subtools_tpu/nn/conformer)."""

from .attention import (GAU, NEG_INF, MultiHeadedAttention, RelPositionMultiHeadedAttention, RoPESelfAttention,
                        T5RelPositionBias, attention_normalize)
from .convolution import ConvolutionModule
from .embedding import (abs_position_encoding, apply_rope, position_table, rel_position_encoding, rope_freqs,
                        sinusoid_table)
from .encoder import (ConformerBlock, ConformerEncoder, PositionwiseFeedForward, RandomCombine, TransformerEncoder,
                      combine, layer_drop_keep, random_combine_weights)
from .mask import add_optional_chunk_mask, chunk_mask, dynamic_chunk_draw, dynamic_chunk_mask, make_pad_mask
from .scaling import BasicNorm, activation_balancer
from .subsampling import (SUBSAMPLINGS, Conv2dSubsampling, Conv2dSubsampling2, Conv2dSubsampling4,
                          Conv2dSubsampling6, Conv2dSubsampling8, LinearNoSubsampling, ReConv2dSubsampling4)

__all__ = [
    "GAU",
    "NEG_INF",
    "BasicNorm",
    "Conv2dSubsampling",
    "Conv2dSubsampling2",
    "Conv2dSubsampling4",
    "Conv2dSubsampling6",
    "Conv2dSubsampling8",
    "ConformerBlock",
    "ConformerEncoder",
    "ConvolutionModule",
    "LinearNoSubsampling",
    "MultiHeadedAttention",
    "PositionwiseFeedForward",
    "RandomCombine",
    "ReConv2dSubsampling4",
    "RelPositionMultiHeadedAttention",
    "RoPESelfAttention",
    "SUBSAMPLINGS",
    "T5RelPositionBias",
    "TransformerEncoder",
    "abs_position_encoding",
    "activation_balancer",
    "add_optional_chunk_mask",
    "apply_rope",
    "attention_normalize",
    "chunk_mask",
    "combine",
    "dynamic_chunk_draw",
    "dynamic_chunk_mask",
    "layer_drop_keep",
    "make_pad_mask",
    "position_table",
    "random_combine_weights",
    "rel_position_encoding",
    "rope_freqs",
    "sinusoid_table",
]
