"""The Conformer encoder stack (counterpart: asv_subtools_tpu/nn/conformer)."""

from .attention import NEG_INF, MultiHeadedAttention, RelPositionMultiHeadedAttention, attention_normalize
from .convolution import ConvolutionModule
from .embedding import position_table, sinusoid_table
from .encoder import ConformerBlock, ConformerEncoder, PositionwiseFeedForward, TransformerEncoder
from .mask import add_optional_chunk_mask, make_pad_mask
from .scaling import BasicNorm, activation_balancer
from .subsampling import SUBSAMPLINGS, Conv2dSubsampling, Conv2dSubsampling2, Conv2dSubsampling4, ReConv2dSubsampling4

__all__ = [
    "NEG_INF",
    "BasicNorm",
    "Conv2dSubsampling",
    "Conv2dSubsampling2",
    "Conv2dSubsampling4",
    "ConformerBlock",
    "ConformerEncoder",
    "ConvolutionModule",
    "MultiHeadedAttention",
    "PositionwiseFeedForward",
    "ReConv2dSubsampling4",
    "RelPositionMultiHeadedAttention",
    "SUBSAMPLINGS",
    "TransformerEncoder",
    "activation_balancer",
    "add_optional_chunk_mask",
    "attention_normalize",
    "make_pad_mask",
    "position_table",
    "sinusoid_table",
]
