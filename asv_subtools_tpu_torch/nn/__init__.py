from .dropout import dropout
from .fused_att_pooling import fused_attentive_stats_pool, fused_attentive_stats_pool_plain
from .fused_res2 import fused_res2_chain, fused_res2_chain_plain
from .fused_stats_pooling import fused_stats_pooling, fused_stats_pooling_plain
from .loss import (
    LOSSES,
    LambdaMAnneal,
    MarginSoftmaxLoss,
    MarginSoftmaxLossV1,
    MarginWarm,
    accuracy,
    cross_entropy,
)
from .norm import BatchNorm, LayerNorm
from .pooling import POOLINGS, FreeStatisticsPooling, StatisticsPooling
from .resnet import BasicBlock, Bottleneck, ResNet, resnet18, resnet34, resnet50, resnet101
from .tdnn import ActivationBatchNorm, ReluBatchNormTdnnLayer, SEBlock2D, TdnnAffine

__all__ = [
    "ActivationBatchNorm",
    "BasicBlock",
    "BatchNorm",
    "Bottleneck",
    "FreeStatisticsPooling",
    "LOSSES",
    "LayerNorm",
    "LambdaMAnneal",
    "MarginSoftmaxLoss",
    "MarginSoftmaxLossV1",
    "MarginWarm",
    "POOLINGS",
    "ReluBatchNormTdnnLayer",
    "ResNet",
    "SEBlock2D",
    "StatisticsPooling",
    "TdnnAffine",
    "accuracy",
    "cross_entropy",
    "dropout",
    "fused_attentive_stats_pool",
    "fused_attentive_stats_pool_plain",
    "fused_res2_chain",
    "fused_res2_chain_plain",
    "fused_stats_pooling",
    "fused_stats_pooling_plain",
    "resnet18",
    "resnet34",
    "resnet50",
    "resnet101",
]
