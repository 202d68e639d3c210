"""Feature-extraction configuration (the port's own copy).

Counterpart: asv_subtools_tpu/features/config.py:18-105 and 156-169. Frozen, hashable
dataclasses so the host-side constant caches in functional.py and
fused_fbank.py can key on them. Semantics follow the Kaldi feature front
end (kaldifeat feature-window.h, feature-fbank.h, mel-computations.h).
"""

from __future__ import annotations

import dataclasses
import math

# float32 machine epsilon: the log floor the Kaldi/kaldifeat front-end uses.
EPSILON = 1.1920928955078125e-07


def round_up_to_nearest_power_of_two(n: int) -> int:
    if n <= 0:
        raise ValueError(f"n must be positive, got {n}")
    return 1 << (n - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class FrameOptions:
    """Framing/windowing options (kaldifeat FrameExtractionOptions parity)."""

    samp_freq: float = 16000.0
    frame_shift_ms: float = 10.0
    frame_length_ms: float = 25.0
    dither: float = 0.0  # std-dev of gaussian dither, in raw sample units
    preemph_coeff: float = 0.97
    remove_dc_offset: bool = True
    window_type: str = "povey"  # povey|hamming|hanning|sine|rectangular|blackman
    round_to_power_of_two: bool = True
    blackman_coeff: float = 0.42
    snip_edges: bool = True

    @property
    def window_shift(self) -> int:
        return int(self.samp_freq * 0.001 * self.frame_shift_ms)

    @property
    def window_size(self) -> int:
        return int(self.samp_freq * 0.001 * self.frame_length_ms)

    @property
    def padded_window_size(self) -> int:
        if self.round_to_power_of_two:
            return round_up_to_nearest_power_of_two(self.window_size)
        return self.window_size

    def num_frames(self, num_samples: int, flush: bool = True) -> int:
        """Frame count for a waveform of `num_samples` samples."""
        shift, length = self.window_shift, self.window_size
        if self.snip_edges:
            if num_samples < length:
                return 0
            return 1 + (num_samples - length) // shift
        num = (num_samples + shift // 2) // shift
        if flush:
            return num
        end = self.first_sample_of_frame(num - 1) + length
        while num > 0 and end > num_samples:
            num -= 1
            end -= shift
        return num

    def first_sample_of_frame(self, frame: int) -> int:
        shift = self.window_shift
        if self.snip_edges:
            return frame * shift
        midpoint = shift * frame + shift // 2
        return midpoint - self.window_size // 2


@dataclasses.dataclass(frozen=True)
class MelOptions:
    """Mel filterbank options (kaldifeat MelBanksOptions parity)."""

    num_bins: int = 23
    low_freq: float = 20.0
    high_freq: float = 0.0  # <=0 means offset from Nyquist
    vtln_low: float = 100.0
    vtln_high: float = -500.0  # <0 means offset from Nyquist


@dataclasses.dataclass(frozen=True)
class FbankOptions:
    frame_opts: FrameOptions = FrameOptions()
    mel_opts: MelOptions = MelOptions()
    use_energy: bool = False
    energy_floor: float = 0.0
    raw_energy: bool = True
    htk_compat: bool = False
    use_log_fbank: bool = True
    use_power: bool = True

    @property
    def dim(self) -> int:
        return self.mel_opts.num_bins + (1 if self.use_energy else 0)


@dataclasses.dataclass(frozen=True)
class VadOptions:
    """Energy-VAD options (Kaldi compute-vad; reference
    runtime/extractor/torch_asv_extractor.cc:14-62 and conf/vad-5.5.conf:
    threshold 5.5, mean scale 0.5)."""

    energy_threshold: float = 5.5
    energy_mean_scale: float = 0.5
    frames_context: int = 0
    proportion_threshold: float = 0.6


def mel_scale(freq):
    return 1127.0 * math.log(1.0 + freq / 700.0)


def inverse_mel_scale(mel):
    return 700.0 * (math.exp(mel / 1127.0) - 1.0)
