from .config import EPSILON, FbankOptions, FrameOptions, MelOptions
from .functional import (
    cmvn_utterance,
    compute_fbank,
    dft_matrices,
    feature_window,
    frame_signal,
    mel_banks,
    power_spectrum,
)
from .fused_fbank import fused_fbank, fused_fbank_plain, wave_features

__all__ = [
    "EPSILON",
    "FbankOptions",
    "FrameOptions",
    "MelOptions",
    "cmvn_utterance",
    "compute_fbank",
    "dft_matrices",
    "feature_window",
    "frame_signal",
    "fused_fbank",
    "fused_fbank_plain",
    "mel_banks",
    "power_spectrum",
    "wave_features",
]
