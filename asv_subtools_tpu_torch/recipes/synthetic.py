"""A synthetic Kaldi-style corpus for smoke runs of the recipe: sinusoid-
mixture speakers (speaker s at a fundamental of 80 + 60 s Hz with four
harmonics of random phase, plus white noise), as the JAX package's launcher
test builds them (tests/test_launcher.py). numpy only; seeded."""

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
