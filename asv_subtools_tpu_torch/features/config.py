"""Feature-extraction configuration (the port's own copy).

Counterpart: asv_subtools_tpu/features/config.py. Frozen, hashable
dataclasses so the host-side constant caches in functional.py and
fused_fbank.py can key on them. Semantics follow the Kaldi feature front
end (kaldifeat feature-window.h, feature-fbank.h, feature-mfcc.h,
feature-plp.h, feature-spectrogram.h, mel-computations.h).
``options_from_kaldi_conf`` builds them from a Kaldi ``.conf`` file (the
reference's conf/*.conf).
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
class MfccOptions:
    frame_opts: FrameOptions = FrameOptions()
    mel_opts: MelOptions = MelOptions()
    num_ceps: int = 13
    use_energy: bool = True
    energy_floor: float = 0.0
    raw_energy: bool = True
    cepstral_lifter: float = 22.0
    htk_compat: bool = False

    @property
    def dim(self) -> int:
        return self.num_ceps


@dataclasses.dataclass(frozen=True)
class PlpOptions:
    """PLP options (kaldifeat PlpOptions parity, feature-plp.h:29-80)."""

    frame_opts: FrameOptions = FrameOptions()
    mel_opts: MelOptions = MelOptions()
    lpc_order: int = 12
    num_ceps: int = 13
    use_energy: bool = True
    energy_floor: float = 0.0
    raw_energy: bool = True
    compress_factor: float = 0.33333
    cepstral_lifter: float = 22.0
    cepstral_scale: float = 1.0
    htk_compat: bool = False

    @property
    def dim(self) -> int:
        return self.num_ceps


@dataclasses.dataclass(frozen=True)
class SpectrogramOptions:
    frame_opts: FrameOptions = FrameOptions()
    energy_floor: float = 0.0
    raw_energy: bool = True

    @property
    def dim(self) -> int:
        return self.frame_opts.padded_window_size // 2 + 1


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


def parse_kaldi_conf(path: str) -> dict:
    """A Kaldi-style feature .conf file -> {option: value}: one
    ``--option=value`` a line, ``#`` comments, booleans true/false, ints and
    floats parsed, anything else kept as a string (the reference's
    conf/*.conf, read by makeFeatures.sh)."""
    opts = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            if not line.startswith("--") or "=" not in line:
                raise ValueError(f"bad kaldi conf line: {line!r}")
            key, val = line[2:].split("=", 1)
            key, val = key.strip(), val.strip()
            if val.lower() in ("true", "false"):
                parsed = val.lower() == "true"
            else:
                try:
                    parsed = int(val)
                except ValueError:
                    try:
                        parsed = float(val)
                    except ValueError:
                        parsed = val
            opts[key] = parsed
    return opts


# Kaldi option name -> dataclass field, by section
_KALDI_FRAME_KEYS = {
    "sample-frequency": "samp_freq",
    "frame-shift": "frame_shift_ms",
    "frame-length": "frame_length_ms",
    "dither": "dither",
    "preemphasis-coefficient": "preemph_coeff",
    "remove-dc-offset": "remove_dc_offset",
    "window-type": "window_type",
    "round-to-power-of-two": "round_to_power_of_two",
    "blackman-coeff": "blackman_coeff",
    "snip-edges": "snip_edges",
}
_KALDI_MEL_KEYS = {
    "num-mel-bins": "num_bins",
    "low-freq": "low_freq",
    "high-freq": "high_freq",
    "vtln-low": "vtln_low",
    "vtln-high": "vtln_high",
}
_KALDI_TOP_KEYS = {
    "use-energy": "use_energy",
    "energy-floor": "energy_floor",
    "raw-energy": "raw_energy",
    "htk-compat": "htk_compat",
    "use-log-fbank": "use_log_fbank",
    "use-power": "use_power",
    "num-ceps": "num_ceps",
    "cepstral-lifter": "cepstral_lifter",
    "lpc-order": "lpc_order",
    "compress-factor": "compress_factor",
    "cepstral-scale": "cepstral_scale",
}
_KALDI_VAD_KEYS = {
    "vad-energy-threshold": "energy_threshold",
    "vad-energy-mean-scale": "energy_mean_scale",
    "vad-frames-context": "frames_context",
    "vad-proportion-threshold": "proportion_threshold",
}
_KALDI_PITCH_KEYS = {
    "sample-frequency": "samp_freq",
    "frame-shift": "frame_shift_ms",
    "frame-length": "frame_length_ms",
    "min-f0": "min_f0",
    "max-f0": "max_f0",
    "resample-frequency": "resample_freq",
    "penalty-factor": "penalty_factor",
    "delta-pitch": "delta_pitch",
    "nccf-ballast": "nccf_ballast",
    "soft-min-f0": "soft_min_f0",
}
_FLOAT_FRAME_FIELDS = ("samp_freq", "frame_shift_ms", "frame_length_ms", "dither", "preemph_coeff", "blackman_coeff")


def options_from_kaldi_conf(path: str, feat_type: str = "fbank"):
    """Feature options from a Kaldi .conf file. ``feat_type``: fbank | mfcc
    | plp | spectrogram | vad | pitch. An option the type does not know
    raises ValueError, as the Kaldi binaries fail on one:

        opts = options_from_kaldi_conf("conf/sre-fbank-81.conf", "fbank")
    """
    raw = parse_kaldi_conf(path)
    if feat_type == "vad":
        fields = {}
        for k, v in raw.items():
            if k in _KALDI_VAD_KEYS:
                fields[_KALDI_VAD_KEYS[k]] = v
            elif k != "sample-frequency":  # compute-vad takes it; the energy VAD does not use it
                raise ValueError(f"unknown vad conf option --{k}")
        return VadOptions(**fields)
    if feat_type == "pitch":
        from .pitch import PitchOptions

        fields = {}
        for k, v in raw.items():
            if k not in _KALDI_PITCH_KEYS:
                raise ValueError(f"unknown pitch conf option --{k}")
            fields[_KALDI_PITCH_KEYS[k]] = v
        return PitchOptions(**fields)

    frame_fields, mel_fields, top_fields = {}, {}, {}
    for k, v in raw.items():
        if k in _KALDI_FRAME_KEYS:
            frame_fields[_KALDI_FRAME_KEYS[k]] = v
        elif k in _KALDI_MEL_KEYS:
            mel_fields[_KALDI_MEL_KEYS[k]] = v
        elif k in _KALDI_TOP_KEYS:
            top_fields[_KALDI_TOP_KEYS[k]] = v
        else:
            raise ValueError(f"unknown {feat_type} conf option --{k}")
    frame = FrameOptions(**{k: float(v) if k in _FLOAT_FRAME_FIELDS else v for k, v in frame_fields.items()})
    mel = MelOptions(**{k: int(v) if k == "num_bins" else float(v) for k, v in mel_fields.items()})
    cls = {"fbank": FbankOptions, "mfcc": MfccOptions, "plp": PlpOptions,
           "spectrogram": SpectrogramOptions}[feat_type]
    bad = set(top_fields) - {f.name for f in dataclasses.fields(cls)}
    if bad:
        raise ValueError(f"options {sorted(bad)} not valid for {feat_type}")
    if feat_type == "spectrogram":
        return cls(frame_opts=frame, **top_fields)
    return cls(frame_opts=frame, mel_opts=mel, **top_fields)
