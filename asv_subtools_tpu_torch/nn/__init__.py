from .fused_att_pooling import fused_attentive_stats_pool, fused_attentive_stats_pool_plain
from .norm import BatchNorm
from .tdnn import ActivationBatchNorm, ReluBatchNormTdnnLayer, TdnnAffine

__all__ = [
    "ActivationBatchNorm",
    "BatchNorm",
    "ReluBatchNormTdnnLayer",
    "TdnnAffine",
    "fused_attentive_stats_pool",
    "fused_attentive_stats_pool_plain",
]
