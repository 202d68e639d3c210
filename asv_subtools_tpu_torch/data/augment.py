"""On-the-fly waveform augmentation (the port's own numpy/scipy copy).

Counterpart: asv_subtools_tpu/data/augment.py, behaviour unchanged
(parity: pytorch/libs/egs/speech_augment.py).

AddNoise (:171) / AddBabble (:533) / AddReverb (:417) from CSV manifests,
DropFreq (:775), DropChunk (:872), DoClip (:1076), SpeedPerturb (:1168),
and the chain/random composition SpeechAug (:1863). Host-side numpy in the
input pipeline workers, stateless given an np.random.Generator.

Manifest CSV format (prepare_speechaug_csv.py): ID, duration, wav, wav_format.
"""

from __future__ import annotations

import csv
import dataclasses
import os
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..io.wav import read_wav
from .signal import (
    compute_amplitude,
    de_silence,
    notch_filter,
    reverberate,
    speed_perturb,
)
from scipy import signal as sps


@dataclasses.dataclass
class NoiseManifest:
    """A list of (path, duration) noise/rir sources from a CSV manifest."""

    items: List[Tuple[str, float]]

    @staticmethod
    def from_csv(path: str) -> "NoiseManifest":
        items = []
        with open(path) as f:
            reader = csv.reader(f)
            header = next(reader, None)
            cols = {name: i for i, name in enumerate(header or [])}
            wav_i = cols.get("wav", 2)
            dur_i = cols.get("duration", 1)
            for row in reader:
                if not row:
                    continue
                items.append((row[wav_i], float(row[dur_i])))
        return NoiseManifest(items)

    def sample(self, rng: np.random.Generator, min_len: int = 0) -> np.ndarray:
        path, _ = self.items[int(rng.integers(len(self.items)))]
        wav, _sr = read_wav(path)
        if wav.ndim > 1:
            wav = wav[0]
        if min_len and len(wav) < min_len:
            reps = -(-min_len // len(wav))
            wav = np.tile(wav, reps)
        return wav


class AddNoise:
    """Mix a random noise at a random SNR (speech_augment.py:171-415)."""

    def __init__(
        self,
        manifest: NoiseManifest,
        snr_low: float = 0.0,
        snr_high: float = 15.0,
        pad_noise: bool = True,
    ):
        self.manifest = manifest
        self.snr_low = snr_low
        self.snr_high = snr_high
        self.pad_noise = pad_noise

    def __call__(self, wav: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        snr = rng.uniform(self.snr_low, self.snr_high)
        noise = self.manifest.sample(rng, min_len=len(wav) if self.pad_noise else 0)
        if len(noise) > len(wav):
            start = int(rng.integers(len(noise) - len(wav) + 1))
            noise = noise[start : start + len(wav)]
        else:
            noise = np.pad(noise, (0, len(wav) - len(noise)))
        clean_amp = compute_amplitude(wav)
        noise_amp = compute_amplitude(noise)
        factor = clean_amp / (10 ** (snr / 20.0)) / max(noise_amp, 1e-14)
        return wav + noise * factor


class AddBabble:
    """Sum several noise sources ("babble", speech_augment.py:533-774)."""

    def __init__(
        self,
        manifest: NoiseManifest,
        speaker_count_low: int = 3,
        speaker_count_high: int = 7,
        snr_low: float = 13.0,
        snr_high: float = 20.0,
    ):
        self.manifest = manifest
        self.low = speaker_count_low
        self.high = speaker_count_high
        self.snr_low = snr_low
        self.snr_high = snr_high

    def __call__(self, wav: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        k = int(rng.integers(self.low, self.high + 1))
        babble = np.zeros(len(wav), np.float32)
        for _ in range(k):
            n = self.manifest.sample(rng, min_len=len(wav))
            if len(n) > len(wav):
                start = int(rng.integers(len(n) - len(wav) + 1))
                n = n[start : start + len(wav)]
            babble += n
        snr = rng.uniform(self.snr_low, self.snr_high)
        clean_amp = compute_amplitude(wav)
        bab_amp = compute_amplitude(babble)
        factor = clean_amp / (10 ** (snr / 20.0)) / max(bab_amp, 1e-14)
        return wav + babble * factor


class AddReverb:
    """Convolve with a random RIR (speech_augment.py:417-531)."""

    def __init__(self, manifest: NoiseManifest):
        self.manifest = manifest

    def __call__(self, wav: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        rir = self.manifest.sample(rng)
        return reverberate(wav, rir).astype(np.float32)


class DropFreq:
    """Notch-filter random frequencies (speech_augment.py:775-870)."""

    def __init__(
        self,
        drop_count_low: int = 1,
        drop_count_high: int = 2,
        drop_freq_low: float = 1e-14,
        drop_freq_high: float = 1.0,
        drop_width: float = 0.05,
    ):
        self.count_low = drop_count_low
        self.count_high = drop_count_high
        self.freq_low = drop_freq_low
        self.freq_high = drop_freq_high
        self.width = drop_width

    def __call__(self, wav: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        k = int(rng.integers(self.count_low, self.count_high + 1))
        out = wav
        for _ in range(k):
            f = rng.uniform(self.freq_low, self.freq_high)
            kernel = notch_filter(f, 101, self.width)
            out = sps.fftconvolve(out, kernel, mode="same")
        return out.astype(np.float32)


class DropChunk:
    """Zero random time chunks (speech_augment.py:872-1074)."""

    def __init__(
        self,
        drop_count_low: int = 1,
        drop_count_high: int = 3,
        drop_length_low: int = 1000,
        drop_length_high: int = 2000,
    ):
        self.count_low = drop_count_low
        self.count_high = drop_count_high
        self.len_low = drop_length_low
        self.len_high = drop_length_high

    def __call__(self, wav: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        out = wav.copy()
        k = int(rng.integers(self.count_low, self.count_high + 1))
        for _ in range(k):
            ln = int(rng.integers(self.len_low, self.len_high + 1))
            if ln >= len(out):
                continue
            start = int(rng.integers(len(out) - ln))
            out[start : start + ln] = 0.0
        return out


class DoClip:
    """Amplitude clipping (speech_augment.py:1076-1166)."""

    def __init__(self, clip_low: float = 0.5, clip_high: float = 1.0):
        self.low = clip_low
        self.high = clip_high

    def __call__(self, wav: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        frac = rng.uniform(self.low, self.high)
        peak = np.max(np.abs(wav)) or 1.0
        limit = peak * frac
        return np.clip(wav, -limit, limit)


class SpeedPerturb:
    """Random speed change from a discrete set; can expand speaker labels
    (the 3-way sp-aug trick, processor.py:177-218)."""

    def __init__(self, speeds: Sequence[float] = (0.9, 1.0, 1.1), sample_rate: int = 16000):
        self.speeds = list(speeds)
        self.sample_rate = sample_rate

    def __call__(self, wav: np.ndarray, rng: np.random.Generator) -> Tuple[np.ndarray, int]:
        idx = int(rng.integers(len(self.speeds)))
        return speed_perturb(wav, self.speeds[idx], self.sample_rate), idx


class SpeechAug:
    """Composable augmentation policy (speech_augment.py:1863-2018).

    mode "chain": apply every stage; "random": pick one (with optional
    probability of clean pass-through).
    """

    def __init__(self, stages: Sequence, mode: str = "random", clean_prob: float = 0.0):
        self.stages = list(stages)
        self.mode = mode
        self.clean_prob = clean_prob

    def __call__(self, wav: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        if not self.stages or (
            self.clean_prob > 0 and rng.uniform() < self.clean_prob
        ):
            return wav
        if self.mode == "chain":
            out = wav
            for s in self.stages:
                out = s(out, rng)
                if isinstance(out, tuple):
                    out = out[0]
            return out
        stage = self.stages[int(rng.integers(len(self.stages)))]
        out = stage(wav, rng)
        return out[0] if isinstance(out, tuple) else out


class EnvCorrupt:
    """Environment-corruption composition: reverb -> babble -> noise, each
    applied with its own probability (speech_augment.py:1606-1727). The
    reference builds this from AddReverb/AddBabble/AddNoise with chained
    SNR semantics (babble over the reverbed signal, noise over the babbled
    one); this class chains the same stages per-sample."""

    def __init__(
        self,
        reverb_manifest: Optional[NoiseManifest] = None,
        noise_manifest: Optional[NoiseManifest] = None,
        babble_manifest: Optional[NoiseManifest] = None,
        reverb_prob: float = 1.0,
        noise_prob: float = 1.0,
        babble_prob: float = 1.0,
        babble_speaker_count: int = 0,
        babble_snr_low: float = 13.0,
        babble_snr_high: float = 20.0,
        noise_snr_low: float = 0.0,
        noise_snr_high: float = 15.0,
    ):
        self.reverb = (
            AddReverb(reverb_manifest)
            if reverb_manifest is not None and reverb_prob > 0
            else None
        )
        self.babble = (
            AddBabble(
                babble_manifest,
                speaker_count_low=babble_speaker_count,
                speaker_count_high=babble_speaker_count,
                snr_low=babble_snr_low,
                snr_high=babble_snr_high,
            )
            if babble_manifest is not None
            and babble_speaker_count > 0
            and babble_prob > 0
            else None
        )
        self.noise = (
            AddNoise(noise_manifest, snr_low=noise_snr_low,
                     snr_high=noise_snr_high)
            if noise_manifest is not None and noise_prob > 0
            else None
        )
        self.reverb_prob = reverb_prob
        self.babble_prob = babble_prob
        self.noise_prob = noise_prob

    def __call__(self, wav: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        out = wav
        if self.reverb is not None and rng.uniform() < self.reverb_prob:
            out = self.reverb(out, rng)
        if self.babble is not None and rng.uniform() < self.babble_prob:
            out = self.babble(out, rng)
        if self.noise is not None and rng.uniform() < self.noise_prob:
            out = self.noise(out, rng)
        return out


class TimeDomainSpecAugment:
    """Time-domain SpecAugment approximation: speed perturb -> drop_freq ->
    drop_chunk, each with its own probability (speech_augment.py:1728-1861).
    keep_shape trims/pads the speed-perturbed waveform back to the input
    length (the reference's keep_shape flag) so downstream static-shape
    batching is unaffected; the label-expanding 3-way sp-aug stays the
    pipeline-level SpeedPerturb/WavEgs path."""

    def __init__(
        self,
        perturb_prob: float = 1.0,
        drop_freq_prob: float = 1.0,
        drop_chunk_prob: float = 1.0,
        speeds: Sequence[float] = (0.95, 1.0, 1.05),
        sample_rate: int = 16000,
        drop_freq_count_low: int = 0,
        drop_freq_count_high: int = 3,
        drop_chunk_count_low: int = 0,
        drop_chunk_count_high: int = 5,
        drop_chunk_length_low: int = 1000,
        drop_chunk_length_high: int = 2000,
        keep_shape: bool = True,
    ):
        self.perturb_prob = perturb_prob
        self.drop_freq_prob = drop_freq_prob
        self.drop_chunk_prob = drop_chunk_prob
        self.speed = SpeedPerturb(speeds, sample_rate)
        self.drop_freq = DropFreq(drop_count_low=drop_freq_count_low,
                                  drop_count_high=drop_freq_count_high)
        self.drop_chunk = DropChunk(
            drop_count_low=drop_chunk_count_low,
            drop_count_high=drop_chunk_count_high,
            drop_length_low=drop_chunk_length_low,
            drop_length_high=drop_chunk_length_high,
        )
        self.keep_shape = keep_shape

    def __call__(self, wav: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        out = wav
        n = len(wav)
        if rng.uniform() < self.perturb_prob:
            out, _ = self.speed(out, rng)
            if self.keep_shape:
                if len(out) >= n:
                    out = out[:n]
                else:
                    out = np.pad(out, (0, n - len(out)))
        if rng.uniform() < self.drop_freq_prob:
            out = self.drop_freq(out, rng)
        if rng.uniform() < self.drop_chunk_prob:
            out = self.drop_chunk(out, rng)
        return out


# -- feature-level SpecAugment (host-side twin of nn.SpecAugmentDropout) ----


def spec_augment(
    feats: np.ndarray,
    rng: np.random.Generator,
    num_t_mask: int = 1,
    num_f_mask: int = 1,
    max_t: int = 50,
    max_f: int = 10,
) -> np.ndarray:
    """Zero random time/freq bands on a [T, D] feature matrix.

    Parity: pytorch/libs/egs/augmentation.py:21-113 (and processor.py:469).
    """
    out = feats.copy()
    t, d = out.shape
    for _ in range(num_t_mask):
        width = int(rng.integers(1, max_t + 1))
        if width < t:
            start = int(rng.integers(t - width))
            out[start : start + width, :] = 0.0
    for _ in range(num_f_mask):
        width = int(rng.integers(1, max_f + 1))
        if width < d:
            start = int(rng.integers(d - width))
            out[:, start : start + width] = 0.0
    return out

def cutout(
    feats: np.ndarray,
    rng: np.random.Generator,
    frequency: float = 0.25,
    frame: float = 0.025,
    num_cut: int = 1,
    random_cut: bool = False,
) -> np.ndarray:
    """Zero random RECTANGLES (not whole bands) on a [T, D] feature matrix.

    Parity: Cutout (pytorch/libs/egs/augmentation.py:114-181) — per cut,
    a freq extent f ~ U{0..int(D*frequency)} at a random offset and a time
    extent t ~ U{0..int(T*frame)} at a random offset are zeroed jointly;
    random_cut draws the number of cuts from U{1..num_cut}. Like the
    reference ctor asserts (:127-128), both proportions must be in (0, 1)
    — a zero extent would be a silent no-op.
    """
    if not (0.0 < frequency < 1.0 and 0.0 < frame < 1.0):
        raise ValueError(
            f"cutout needs 0 < frequency, frame < 1; got {frequency}, {frame}"
        )
    out = feats.copy()
    t, d = out.shape
    max_f = int(d * frequency)
    max_t = int(t * frame)
    n = int(rng.integers(1, num_cut + 1)) if random_cut else num_cut
    for _ in range(n):
        f = int(rng.integers(0, max_f + 1))
        f0 = int(rng.integers(0, d - f + 1))
        w = int(rng.integers(0, max_t + 1))
        t0 = int(rng.integers(0, t - w + 1))
        out[t0 : t0 + w, f0 : f0 + f] = 0.0
    return out


def spec_augment_proportional(
    feats: np.ndarray,
    rng: np.random.Generator,
    frequency: float = 0.2,
    frame: float = 0.0,
    rows: int = 1,
    cols: int = 0,
    random_rows: bool = False,
    random_cols: bool = False,
) -> np.ndarray:
    """SpecAugment with proportional max widths, the offline-egs variant.

    Parity: SpecAugment (pytorch/libs/egs/augmentation.py:21-113): `rows`
    frequency masks of extent U{0..int(D*frequency)} and `cols` time masks
    of extent U{0..int(T*frame)}; random_rows/random_cols draw the mask
    counts from U{1..rows}/U{1..cols}; after each frequency mask the WHOLE
    matrix is rescaled by D/(D-f) (the reference's inverted_factor,
    :88-94); the op is a no-op unless BOTH proportions are > 0 (:55).
    (The online-pipeline spec_augment above keeps wenet's absolute
    max_t/max_f convention, processor.py:469-494.)
    """
    if not (0.0 <= frequency < 1.0 and 0.0 <= frame < 1.0):
        raise ValueError(
            f"specaugment needs 0 <= frequency, frame < 1; got "
            f"{frequency}, {frame}"
        )
    if not (frequency > 0.0 and frame > 0.0):
        return feats  # reference :55: both-or-nothing gating
    out = feats.copy()
    t, d = out.shape
    max_f = int(d * frequency)
    n = int(rng.integers(1, rows + 1)) if random_rows else rows
    for _ in range(n):
        f = int(rng.integers(0, max_f + 1))
        f0 = int(rng.integers(0, d - f + 1))
        out[:, f0 : f0 + f] = 0.0
        out *= d / (d - f)
    max_t = int(t * frame)
    n = int(rng.integers(1, cols + 1)) if random_cols else cols
    for _ in range(n):
        w = int(rng.integers(0, max_t + 1))
        t0 = int(rng.integers(0, t - w + 1))
        out[t0 : t0 + w, :] = 0.0
    return out


def get_augmentation(aug: Optional[str] = None, aug_params: Optional[Dict] = None):
    """Feature-augmentation factory for the offline chunk-egs path.

    Parity: get_augmentation (pytorch/libs/egs/augmentation.py:185-210):
    dispatches "specaugment" | "cutout" | None. Returns a callable
    ``fn(feats [T, D], rng) -> feats`` or None.
    """
    p = {
        "frequency": 0.2,
        "frame": 0.0,
        "rows": 1,
        "cols": 0,
        "random_rows": True,
        "random_cols": False,
        "num_cut": 1,
        "random_cut": False,
    }
    p.update(aug_params or {})
    if aug is None or aug == "" or aug is False:
        return None
    if aug == "specaugment":
        return lambda feats, rng: spec_augment_proportional(
            feats, rng, frequency=p["frequency"], frame=p["frame"],
            rows=p["rows"], cols=p["cols"], random_rows=p["random_rows"],
            random_cols=p["random_cols"],
        )
    if aug == "cutout":
        return lambda feats, rng: cutout(
            feats, rng, frequency=p["frequency"], frame=p["frame"],
            num_cut=p["num_cut"], random_cut=p["random_cut"],
        )
    raise TypeError(f"Do not support {aug} augmentation.")


def speech_aug_from_config(cfg: Optional[Dict]) -> Optional[SpeechAug]:
    """Build a waveform SpeechAug chain from a config dict.

    Parity: the reference launchers configure waveform augmentation
    through a speech_aug yaml fed to SpeechAug(aug_classes=[...])
    (pytorch/launcher/runEcapaXvector_online.py egs params +
    egs/speech_augment.py:1863-2018). Dict shape:

        {"mode": "random"|"chain", "clean_prob": 0.25,
         "stages": [
            {"type": "add_noise", "csv": "noise.csv", "snr_low": 0, ...},
            {"type": "add_babble", "csv": "noise.csv", ...},
            {"type": "add_reverb", "csv": "rir.csv"},
            {"type": "drop_freq", ...}, {"type": "drop_chunk", ...},
            {"type": "clip", ...}, {"type": "speed_perturb", ...},
            {"type": "env_corrupt", "reverb_csv": ..., "noise_csv": ...,
             "babble_csv": ..., "babble_speaker_count": 3, ...},
            {"type": "time_domain_specaug", "speeds": [0.95, 1.0, 1.05]},
         ]}

    The env_corrupt / time_domain_specaug stage types build the reference's
    speechbrain composition wrappers (EnvCorrupt :1606, TimeDomainSpecAugment
    :1728) — its shipped speech_aug yamls compose exactly these two.

    Returns None for a falsy cfg (augmentation off).
    """
    if not cfg:
        return None
    needs_csv = {"add_noise", "add_babble", "add_reverb"}
    stage_classes = {
        "add_noise": AddNoise,
        "add_babble": AddBabble,
        "add_reverb": AddReverb,
        "drop_freq": DropFreq,
        "drop_chunk": DropChunk,
        "clip": DoClip,
        "speed_perturb": SpeedPerturb,
        "time_domain_specaug": TimeDomainSpecAugment,
    }
    stages = []
    for s in cfg.get("stages", []):
        s = dict(s)
        kind = s.pop("type")
        if kind == "env_corrupt":
            for key in ("reverb", "noise", "babble"):
                csv_path = s.pop(f"{key}_csv", None)
                if csv_path:
                    s[f"{key}_manifest"] = NoiseManifest.from_csv(csv_path)
            stages.append(EnvCorrupt(**s))
            continue
        if kind not in stage_classes:
            raise TypeError(f"unknown speech_aug stage {kind!r} "
                            f"(have {sorted(stage_classes) + ['env_corrupt']})")
        if kind in needs_csv:
            manifest = NoiseManifest.from_csv(s.pop("csv"))
            stages.append(stage_classes[kind](manifest, **s))
        else:
            stages.append(stage_classes[kind](**s))
    return SpeechAug(
        stages,
        mode=cfg.get("mode", "random"),
        clean_prob=float(cfg.get("clean_prob", 0.0)),
    )


def prepare_speechaug_csv(
    wav_dir: str,
    out_csv: str,
    *,
    extensions=(".wav",),
    sample_rate_hint: int = 16000,
) -> int:
    """Scan a noise/RIR corpus directory tree into a NoiseManifest CSV
    (parity: pipeline/onestep/prepare_speechaug_csv.py — builds the
    MUSAN/RIRS manifests preprocess_wav_egs.sh feeds to SpeechAug).
    Columns: id,duration,wav. Returns the number of rows written.
    """
    import csv as _csv
    import os
    import wave as _wave

    rows = []
    for root, _dirs, files in os.walk(wav_dir):
        for name in sorted(files):
            if not name.lower().endswith(tuple(extensions)):
                continue
            path = os.path.join(root, name)
            try:
                with _wave.open(path, "rb") as w:
                    dur = w.getnframes() / float(w.getframerate())
            except Exception:
                from ..io.wav import read_wav

                try:
                    wav, sr = read_wav(path)
                    dur = len(wav) / float(sr or sample_rate_hint)
                except Exception:
                    continue
            rows.append((os.path.splitext(name)[0], dur, path))
    os.makedirs(os.path.dirname(os.path.abspath(out_csv)), exist_ok=True)
    with open(out_csv, "w", newline="") as f:
        writer = _csv.writer(f)
        writer.writerow(["id", "duration", "wav"])
        writer.writerows(rows)
    return len(rows)
