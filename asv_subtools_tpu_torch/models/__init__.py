from .conformer import ConformerXvector
from .ecapa import EcapaAttentiveStatsPool, EcapaTdnn, Res2NetBlock, SEConnect, SERes2Block
from .framework import SpeakerNet, chunk_utterance, l2_norm
from .resnet_xvector import ResNetXvector
from .xvector import ExtendedXvector, FactoredXvector, SnowdarXvector, Xvector


def _not_ported(name: str):
    def build(*args, **kwargs):
        raise NotImplementedError(f"model {name!r} is not ported yet (ROADMAP Queue 1 item 8)")

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
    **{name: _not_ported(name) for name in ("ecapa_lawlict", "repvgg_xvector", "multi_task_xvector", "fd_xvector")},
}

__all__ = [
    "ConformerXvector",
    "EcapaAttentiveStatsPool",
    "EcapaTdnn",
    "ExtendedXvector",
    "FactoredXvector",
    "MODELS",
    "Res2NetBlock",
    "ResNetXvector",
    "SEConnect",
    "SERes2Block",
    "SnowdarXvector",
    "SpeakerNet",
    "Xvector",
    "chunk_utterance",
    "l2_norm",
]
