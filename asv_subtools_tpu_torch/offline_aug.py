"""Offline 1:N augmentation datadir workflow (the port's own copy of
asv_subtools_tpu/offline_aug.py, behaviour unchanged: numpy on the host).

Parity: the reference's persistent-copies recipe path,
`augmentDataByNoise.sh:1-196` (per-type aug copies with suffixed utt-ids,
VAD carry-over, combine + factor subset + combine-with-clean),
`computeAugmentedVad.sh` (clean vad -> aug.vad by suffix mapping) and
`correctSpeakerAfterSp3way.sh` (sp-prefix -> suffix rename + speaker-id
recovery). This is the workflow behind the ResNet34 offline-aug baseline
(reference README.md:509-514).

Instead of kaldi wav-pipe commands executed at read time, the augmented
waveforms are written once (16-bit wavs) with the same data/augment.py
primitives the online path uses, and the result is a plain datadir that
any later stage (egs, features) reads as it reads a clean one. SNRs are
drawn from the reference's discrete lists (augment_data_dir.py
--fg-snrs/--bg-snrs). One ``np.random.default_rng(seed)`` draws them all,
as in JAX, so the same seed writes the same datadir and wavs.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from .data.augment import AddBabble, AddReverb, NoiseManifest
from .data.signal import compute_amplitude
from .datadir import DataDir
from .io.wav import read_wav, write_wav

# reference SNR lists (augmentDataByNoise.sh:123,141,158)
FG_NOISE_SNRS = (15.0, 10.0, 5.0, 0.0)
BG_MUSIC_SNRS = (15.0, 10.0, 8.0, 5.0)
BG_BABBLE_SNRS = (20.0, 17.0, 15.0, 13.0)


def _mix_at_snr(wav: np.ndarray, noise: np.ndarray, snr_db: float) -> np.ndarray:
    if len(noise) < len(wav):
        noise = np.tile(noise, -(-len(wav) // len(noise)))
    if len(noise) > len(wav):
        noise = noise[: len(wav)]
    clean_amp = compute_amplitude(wav)
    noise_amp = compute_amplitude(noise)
    factor = clean_amp / (10 ** (snr_db / 20.0)) / max(noise_amp, 1e-14)
    return (wav + noise * factor).astype(np.float32)


def augment_data_dir(
    data_path: str,
    out_path: str,
    *,
    reverb_csv: Optional[str] = None,
    noise_csv: Optional[str] = None,
    music_csv: Optional[str] = None,
    babble_csv: Optional[str] = None,
    factor: float = 1.0,
    seed: int = 1024,
    sample_rate: int = 16000,
) -> DataDir:
    """Create persistent augmented copies and the combined train datadir.

    For each provided manifest a full suffixed copy ("utt-reverb",
    "utt-noise", "utt-music", "utt-babble") is synthesized into
    `out_path/wav/<type>/`; vad.scp/utt2num_frames entries are carried
    over by key (aug preserves timing). The returned (and written)
    datadir = clean + a `factor * len(clean)` subset of the additive
    copies, exactly augmentDataByNoise.sh's factor semantics.
    """
    rng = np.random.default_rng(seed)
    clean = DataDir.read(data_path)
    wav_table = clean.tables.get("wav.scp", {})
    if not wav_table:
        raise ValueError(f"{data_path}/wav.scp is empty")

    aug_specs = []
    if reverb_csv:
        aug_specs.append(("reverb", AddReverb(NoiseManifest.from_csv(reverb_csv))))
    if noise_csv:
        man = NoiseManifest.from_csv(noise_csv)

        def fg_noise(wav, r, _m=man):
            snr = float(r.choice(FG_NOISE_SNRS))
            return _mix_at_snr(wav, _m.sample(r, min_len=len(wav)), snr)

        aug_specs.append(("noise", fg_noise))
    if music_csv:
        man_m = NoiseManifest.from_csv(music_csv)

        def bg_music(wav, r, _m=man_m):
            snr = float(r.choice(BG_MUSIC_SNRS))
            return _mix_at_snr(wav, _m.sample(r, min_len=len(wav)), snr)

        aug_specs.append(("music", bg_music))
    if babble_csv:
        aug_specs.append(
            (
                "babble",
                AddBabble(
                    NoiseManifest.from_csv(babble_csv),
                    speaker_count_low=3,
                    speaker_count_high=7,
                    snr_low=min(BG_BABBLE_SNRS),
                    snr_high=max(BG_BABBLE_SNRS),
                ),
            )
        )
    if not aug_specs:
        raise ValueError("no augmentation manifests provided")

    carry_tables = [
        t for t in ("vad.scp", "utt2num_frames", "utt2dur", "reco2dur")
        if t in clean.tables
    ]

    copies: List[DataDir] = []
    for suffix, fn in aug_specs:
        wav_dir = os.path.join(out_path, "wav", suffix)
        os.makedirs(wav_dir, exist_ok=True)
        tables: Dict[str, Dict[str, str]] = {"wav.scp": {}, "utt2spk": {}}
        for t in carry_tables:
            tables[t] = {}
        u2s = clean.tables.get("utt2spk", {})
        for utt, path in wav_table.items():
            wav, sr = read_wav(path)
            if wav.ndim > 1:
                wav = wav[0]
            out = fn(np.asarray(wav, np.float32), rng)
            new_key = f"{utt}-{suffix}"
            out_file = os.path.join(wav_dir, f"{new_key}.wav")
            write_wav(out_file, out, sr)
            tables["wav.scp"][new_key] = out_file
            if utt in u2s:
                tables["utt2spk"][new_key] = u2s[utt]
            for t in carry_tables:
                if utt in clean.tables[t]:
                    tables[t][new_key] = clean.tables[t][utt]
        copies.append(DataDir(tables))

    additive = copies[0]
    for c in copies[1:]:
        additive = additive.combine(c)

    factor = min(float(factor), float(len(aug_specs)))
    n_subset = int(len(clean) * factor)
    if n_subset <= 0:
        raise ValueError(f"factor {factor} selects zero augmented utts")
    if n_subset < len(additive):
        additive = additive.subset(num_utts=n_subset, seed=seed)

    out = clean.combine(additive)
    out.write(out_path)
    return out


def compute_augmented_vad(
    aug_dir: str,
    clean_vad_scp: str,
    suffixes: Sequence[str] = ("reverb", "noise", "music", "babble"),
) -> DataDir:
    """Carry clean VAD marks onto augmentation copies
    (computeAugmentedVad.sh:40-50): clean vad.scp rows are duplicated for
    every `utt-<suffix>`; utts in the datadir with no clean VAD are listed
    in lost_clean.utts and the written vad.scp covers the rest."""
    dd = DataDir.read(aug_dir)
    clean_vad: Dict[str, str] = {}
    with open(clean_vad_scp) as f:
        for line in f:
            parts = line.strip().split(None, 1)
            if len(parts) == 2:
                clean_vad[parts[0]] = parts[1]

    aug_vad = dict(clean_vad)
    for sfx in suffixes:
        for k, v in clean_vad.items():
            aug_vad[f"{k}-{sfx}"] = v

    vad_table: Dict[str, str] = {}
    lost: List[str] = []
    for utt in dd.utts:
        if utt in aug_vad:
            vad_table[utt] = aug_vad[utt]
        else:
            lost.append(utt)
    dd.tables["vad.scp"] = vad_table
    with open(os.path.join(aug_dir, "vad.scp"), "w") as f:
        for k, v in vad_table.items():
            f.write(f"{k} {v}\n")
    with open(os.path.join(aug_dir, "lost_clean.utts"), "w") as f:
        for k in lost:
            f.write(k + "\n")
    return dd


def correct_speaker_after_sp3way(
    dd: DataDir, factors: Sequence[str] = ("0.9", "1.1"), extra_factor: str = ""
) -> DataDir:
    """Undo sp-prefix speaker pollution after 3-way speed perturb
    (correctSpeakerAfterSp3way.sh): utt-ids `spX-utt` become `utt-spX` in
    every table, and speaker-ids lose their `spX-` prefix so perturbed
    copies score to the ORIGINAL speaker (the lre/sre convention)."""
    fset = [f for f in list(factors) + [extra_factor] if f]
    prefixes = [f"sp{f}-" for f in fset]

    def fix_key(k: str) -> str:
        for p in prefixes:
            if k.startswith(p):
                return f"{k[len(p):]}-{p[:-1]}"
        return k

    out = {}
    for name, table in dd.tables.items():
        new_table = {fix_key(k): v for k, v in table.items()}
        if name == "utt2spk":
            for p in prefixes:
                new_table = {
                    k: (v[len(p):] if v.startswith(p) else v)
                    for k, v in new_table.items()
                }
        out[name] = new_table
    return DataDir(out)
