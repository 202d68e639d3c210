from .conformer import ConformerXvector
from .ecapa import EcapaAttentiveStatsPool, EcapaTdnn, Res2NetBlock, SEConnect, SERes2Block
from .framework import SpeakerNet, chunk_utterance, l2_norm
from .resnet_xvector import ResNetXvector

__all__ = [
    "ConformerXvector",
    "EcapaAttentiveStatsPool",
    "EcapaTdnn",
    "Res2NetBlock",
    "ResNetXvector",
    "SEConnect",
    "SERes2Block",
    "SpeakerNet",
    "chunk_utterance",
    "l2_norm",
]
