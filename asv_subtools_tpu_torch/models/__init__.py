from .conformer import ConformerXvector
from .ecapa import EcapaAttentiveStatsPool, EcapaTdnn, Res2NetBlock, SEConnect, SERes2Block
from .ecapa_lawlict import (EcapaLawlict, LawlictAttentiveStatsPool, LawlictRes2Block, LawlictSERes2Block,
                            SEConnectLinear)
from .framework import SpeakerNet, chunk_utterance, count_params, extract_embedding_chunked, l2_norm
from .multitask import DALRegularizer, FDXvector, MultiTaskNet, MultiTaskXvector, fd_adversarial_loss, phone_frame_loss
from .resnet_xvector import RepVggXvector, ResNetXvector, deploy_repvgg_xvector
from .xvector import ExtendedXvector, FactoredXvector, SnowdarXvector, Xvector


# the Launcher's model names (JAX models/__init__.py:36-48)
MODELS = {
    "ecapa_tdnn": EcapaTdnn,
    "resnet_xvector": ResNetXvector,
    "conformer_xvector": ConformerXvector,
    "xvector": Xvector,
    "snowdar_xvector": SnowdarXvector,
    "extended_xvector": ExtendedXvector,
    "factored_xvector": FactoredXvector,
    "ecapa_lawlict": EcapaLawlict,
    "repvgg_xvector": RepVggXvector,
    "multi_task_xvector": MultiTaskXvector,
    "fd_xvector": FDXvector,
}

__all__ = [
    "ConformerXvector",
    "DALRegularizer",
    "EcapaAttentiveStatsPool",
    "EcapaLawlict",
    "EcapaTdnn",
    "ExtendedXvector",
    "FDXvector",
    "FactoredXvector",
    "LawlictAttentiveStatsPool",
    "LawlictRes2Block",
    "LawlictSERes2Block",
    "MODELS",
    "MultiTaskNet",
    "MultiTaskXvector",
    "RepVggXvector",
    "Res2NetBlock",
    "ResNetXvector",
    "SEConnect",
    "SEConnectLinear",
    "SERes2Block",
    "SnowdarXvector",
    "SpeakerNet",
    "Xvector",
    "chunk_utterance",
    "count_params",
    "deploy_repvgg_xvector",
    "extract_embedding_chunked",
    "fd_adversarial_loss",
    "l2_norm",
    "phone_frame_loss",
]
