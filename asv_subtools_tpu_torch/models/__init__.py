from .conformer import ConformerXvector
from .ecapa import EcapaAttentiveStatsPool, EcapaTdnn, Res2NetBlock, SEConnect, SERes2Block
from .ecapa_lawlict import (EcapaLawlict, LawlictAttentiveStatsPool, LawlictRes2Block, LawlictSERes2Block,
                            SEConnectLinear)
from .framework import SpeakerNet, chunk_utterance, l2_norm
from .resnet_xvector import RepVggXvector, ResNetXvector, deploy_repvgg_xvector
from .xvector import ExtendedXvector, FactoredXvector, SnowdarXvector, Xvector


def _not_ported(name: str):
    def build(*args, **kwargs):
        raise NotImplementedError(f"model {name!r} is not ported yet: it trains on the offline chunk egs "
                                  "(ROADMAP Queue 1 item 4)")

    return build


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
    **{name: _not_ported(name) for name in ("multi_task_xvector", "fd_xvector")},
}

__all__ = [
    "ConformerXvector",
    "EcapaAttentiveStatsPool",
    "EcapaLawlict",
    "EcapaTdnn",
    "ExtendedXvector",
    "FactoredXvector",
    "LawlictAttentiveStatsPool",
    "LawlictRes2Block",
    "LawlictSERes2Block",
    "MODELS",
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
    "deploy_repvgg_xvector",
    "l2_norm",
]
