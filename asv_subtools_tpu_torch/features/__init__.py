from .config import EPSILON, FbankOptions, FrameOptions, MelOptions, VadOptions
from .functional import (
    cmvn_sliding,
    cmvn_utterance,
    compute_fbank,
    compute_vad_energy,
    dft_matrices,
    feature_window,
    frame_signal,
    mel_banks,
    power_spectrum,
    select_voiced_frames,
)
from .fused_fbank import fused_fbank, fused_fbank_plain, wave_features

__all__ = [
    "EPSILON",
    "FbankOptions",
    "FrameOptions",
    "MelOptions",
    "VadOptions",
    "cmvn_sliding",
    "cmvn_utterance",
    "compute_fbank",
    "compute_vad_energy",
    "dft_matrices",
    "feature_window",
    "frame_signal",
    "fused_fbank",
    "fused_fbank_plain",
    "mel_banks",
    "power_spectrum",
    "select_voiced_frames",
    "wave_features",
]
