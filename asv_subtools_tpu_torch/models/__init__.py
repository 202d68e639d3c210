from .conformer import ConformerXvector
from .ecapa import EcapaAttentiveStatsPool, EcapaTdnn, Res2NetBlock, SEConnect, SERes2Block
from .framework import SpeakerNet, chunk_utterance, l2_norm
from .resnet_xvector import ResNetXvector


def _not_ported(name: str):
    def build(*args, **kwargs):
        raise NotImplementedError(f"model {name!r} is not ported yet (ROADMAP Queue 1 item 8)")

    return build


# the Launcher's model names (JAX models/__init__.py:36-48)
MODELS = {
    "ecapa_tdnn": EcapaTdnn,
    "resnet_xvector": ResNetXvector,
    "conformer_xvector": ConformerXvector,
    **{name: _not_ported(name) for name in (
        "xvector", "snowdar_xvector", "extended_xvector", "factored_xvector", "ecapa_lawlict", "repvgg_xvector",
        "multi_task_xvector", "fd_xvector")},
}

__all__ = [
    "ConformerXvector",
    "EcapaAttentiveStatsPool",
    "EcapaTdnn",
    "MODELS",
    "Res2NetBlock",
    "ResNetXvector",
    "SEConnect",
    "SERes2Block",
    "SpeakerNet",
    "chunk_utterance",
    "l2_norm",
]
