"""A synthetic Kaldi-style corpus for smoke runs of the recipe: sinusoid-
mixture speakers (speaker s at a fundamental of 80 + 60 s Hz with four
harmonics of random phase, plus white noise), as the JAX package's launcher
test builds them (tests/test_launcher.py). numpy only; seeded.

For the offline chunk-egs route: ``write_feature_datadir`` runs the
Kaldi-style host front end over a corpus subset (fbank with dither, energy
VAD, sliding CMVN, voiced frames) into a feature data dir, and
``write_offline_labels`` adds seeded frame phone alignments and auxiliary
class labels for the multi-task and FD x-vectors."""

import os
from typing import Optional, Tuple

import numpy as np

from ..io.wav import write_wav

SR = 16000


def write_corpus(root: str, num_spks: int = 4, train_per_spk: int = 6, eval_per_spk: int = 2,
                 dur: Tuple[float, float] = (1.2, 2.2), eval_dur: Tuple[float, float] = None, seed: int = 7,
                 num_langs: Optional[int] = None) -> str:
    """Write ``root``/train/{wav.scp,utt2spk,utt2lang} and
    ``root``/eval/{wav.scp,utt2spk,utt2lang} over wavs in ``root``/wav: per
    speaker ``train_per_spk`` utterances of ``dur`` seconds (uniform) and
    ``eval_per_spk`` of ``eval_dur`` (default ``dur``). Keys are
    ``s<spk>-u<i>``. utt2lang serves the corpus as a language set: speaker
    s speaks language ``lang<s % num_langs>`` (by default one language a
    speaker). ``root``/eval/trials (Kaldi "enroll test target|nontarget"
    lines) holds every pair of eval utterances of one speaker and as many
    pairs of two speakers, drawn from ``seed`` without repeats. Returns
    ``root``."""
    num_langs = num_langs or num_spks
    rng = np.random.default_rng(seed)
    lines = {"train": ([], [], []), "eval": ([], [], [])}
    os.makedirs(os.path.join(root, "wav"), exist_ok=True)
    for spk in range(num_spks):
        f0 = 80.0 + 60.0 * spk
        for i in range(train_per_spk + eval_per_spk):
            subset = "train" if i < train_per_spk else "eval"
            key = f"s{spk:02d}-u{i}"
            lo, hi = dur if subset == "train" or eval_dur is None else eval_dur
            t = np.arange(int(SR * rng.uniform(lo, hi))) / SR
            wav = sum(np.sin(2 * np.pi * f0 * (h + 1) * t + rng.uniform(0, 6.28)) / (h + 1) for h in range(4))
            wav = (wav * 3000 + rng.normal(size=len(t)) * 100).astype(np.float32)
            path = os.path.join(root, "wav", f"{key}.wav")
            write_wav(path, wav, SR)
            lines[subset][0].append(f"{key} {path}")
            lines[subset][1].append(f"{key} spk{spk:02d}")
            lines[subset][2].append(f"{key} lang{spk % num_langs:02d}")
    for subset, (wav_lines, spk_lines, lang_lines) in lines.items():
        os.makedirs(os.path.join(root, subset), exist_ok=True)
        for name, rows in (("wav.scp", wav_lines), ("utt2spk", spk_lines), ("utt2lang", lang_lines)):
            with open(os.path.join(root, subset, name), "w") as f:
                f.write("\n".join(rows) + "\n")
    eval_keys = [line.split()[0] for line in lines["eval"][0]]
    pairs = [(a, b) for i, a in enumerate(eval_keys) for b in eval_keys[i + 1:]]
    target = [(a, b) for a, b in pairs if a.split("-")[0] == b.split("-")[0]]
    nontarget = [(a, b) for a, b in pairs if a.split("-")[0] != b.split("-")[0]]
    # a generator of its own: the list depends on the seed and the keys only
    pick = np.random.default_rng(seed).choice(len(nontarget), size=min(len(target), len(nontarget)), replace=False)
    with open(os.path.join(root, "eval", "trials"), "w") as f:
        f.writelines(f"{a} {b} target\n" for a, b in target)
        f.writelines(f"{nontarget[i][0]} {nontarget[i][1]} nontarget\n" for i in sorted(pick))
    return root


def write_feature_datadir(wav_dir: str, out_dir: str, num_bins: int = 80, seed: int = 7) -> int:
    """Kaldi-style host features of ``wav_dir``/wav.scp (makeFeatures.sh,
    compute-vad, apply-cmvn-sliding, select-voiced-frames) into
    ``out_dir``/{feats.ark, feats.scp, utt2num_frames, utt2spk}: fbank of
    ``num_bins`` bins with raw log energy, dithered at Kaldi's default 1.0
    from a numpy Generator seeded ``seed``; energy VAD (VadOptions()) on
    the energy column; sliding CMVN over the bins (a 300-frame window);
    the voiced frames, in order. The port's plain front end on CPU
    tensors. Returns the number of utterances."""
    import torch

    from ..features import (FbankOptions, FrameOptions, MelOptions, VadOptions, cmvn_sliding, compute_fbank,
                            compute_vad_energy, select_voiced_frames)
    from ..io import ArkScpWriter, read_wav

    opts = FbankOptions(frame_opts=FrameOptions(dither=1.0), mel_opts=MelOptions(num_bins=num_bins),
                        use_energy=True)
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(wav_dir, "wav.scp")) as f:
        entries = [line.split(None, 1) for line in f if line.strip()]
    frames = []
    with ArkScpWriter(os.path.join(out_dir, "feats.ark"), os.path.join(out_dir, "feats.scp"), matrix=True) as w:
        for key, path in entries:
            wav, _ = read_wav(path.strip())
            with torch.no_grad():
                feats = compute_fbank(torch.from_numpy(np.asarray(wav, np.float32).reshape(-1)), opts, rng=rng,
                                      fft_mode="rfft")
                voiced = compute_vad_energy(feats[:, 0], VadOptions())
                kept, mask = select_voiced_frames(cmvn_sliding(feats[:, 1:], window=300), voiced)
            n = int(mask.sum())
            w.write(key, kept[:n].numpy())
            frames.append(f"{key} {n}")
    with open(os.path.join(out_dir, "utt2num_frames"), "w") as f:
        f.write("\n".join(frames) + "\n")
    with open(os.path.join(wav_dir, "utt2spk")) as src, open(os.path.join(out_dir, "utt2spk"), "w") as dst:
        dst.write(src.read())
    return len(entries)


def write_offline_labels(feat_dir: str, num_phones: int = 128, num_aux: int = 9, seed: int = 7) -> Tuple[str, str]:
    """Seeded labels for ``feat_dir``'s utterances: a phone alignment ark
    of int vectors, one label a frame (``ali.ark``, ``ali.scp``: the format
    ali-to-phones writes), and ``utt2aux``, an auxiliary class a
    speaker (utt2spk's speakers in sorted order, modulo ``num_aux``).
    Returns (ali.scp path, utt2aux path)."""
    from ..io import write_vec_int

    rng = np.random.default_rng(seed)
    with open(os.path.join(feat_dir, "utt2num_frames")) as f:
        frames = [(k, int(v)) for k, v in (line.split() for line in f if line.strip())]
    with open(os.path.join(feat_dir, "utt2spk")) as f:
        u2s = dict(line.split()[:2] for line in f if line.strip())
    spk_id = {s: i for i, s in enumerate(sorted(set(u2s.values())))}
    ark, scp, aux = (os.path.join(feat_dir, name) for name in ("ali.ark", "ali.scp", "utt2aux"))
    if os.path.exists(ark):
        os.remove(ark)
    lines = [f"{key} {os.path.abspath(ark)}:{write_vec_int(ark, rng.integers(0, num_phones, size=n), key)}"
             for key, n in frames]
    with open(scp, "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(aux, "w") as f:
        f.write("\n".join(f"{key} {spk_id[u2s[key]] % num_aux}" for key, _ in frames) + "\n")
    return scp, aux
