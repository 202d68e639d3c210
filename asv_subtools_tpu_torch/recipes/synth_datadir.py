"""Materialize the quality gate's corpus as a Kaldi-style data directory
(counterpart: tools/make_synth_datadir.py).

Writes ``{out}/{train,eval}/wav/*.wav`` (16-bit PCM), ``wav.scp`` and
``utt2spk`` for each subset, and ``{out}/trials`` (every pair of eval
utterances, target iff same speaker): the same files as the JAX tool for
the same arguments, so the recipe path and the RepVGG deploy gate can run
on a disk-backed corpus.

Usage: python -m asv_subtools_tpu_torch.recipes.synth_datadir --out DIR
         [--spk 48] [--train-utts 12] [--eval-utts 4] [--dur 4.0] [--seed 7]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..io.wav import write_wav
from .gate_corpus import SR, Renderer, make_speaker


def write_datadir(out: str, spk: int = 48, train_utts: int = 12, eval_utts: int = 4, dur: float = 4.0,
                  seed: int = 7, render=None) -> int:
    """Write the corpus; -> the number of trials. ``render`` (a
    ``gate_corpus.Renderer``) renders the waves, serially by default."""
    rng = np.random.default_rng(seed)
    speakers = [make_speaker(rng) for _ in range(spk)]
    render = render or Renderer(0)

    for subset, n_utts in (("train", train_utts), ("eval", eval_utts)):
        ddir = os.path.join(out, subset)
        wdir = os.path.join(ddir, "wav")
        os.makedirs(wdir, exist_ok=True)
        scp, u2s, waits = [], [], []
        for s, spk_ in enumerate(speakers):
            for u in range(n_utts):
                utt = f"spk{s:03d}-{subset}{u:03d}"
                path = os.path.join(wdir, utt + ".wav")
                waits.append((path, render.submit(rng, "synth", spk_, dur)))
                scp.append(f"{utt} {path}")
                u2s.append(f"{utt} spk{s:03d}")
        for path, wait in waits:
            write_wav(path, wait(), SR)
        with open(os.path.join(ddir, "wav.scp"), "w") as f:
            f.write("\n".join(scp) + "\n")
        with open(os.path.join(ddir, "utt2spk"), "w") as f:
            f.write("\n".join(u2s) + "\n")

    eval_list = [f"spk{s:03d}-eval{u:03d}" for s in range(spk) for u in range(eval_utts)]
    with open(os.path.join(out, "trials"), "w") as f:
        for i, a in enumerate(eval_list):
            for b in eval_list[i + 1:]:
                tgt = "target" if a.split("-")[0] == b.split("-")[0] else "nontarget"
                f.write(f"{a} {b} {tgt}\n")
    return len(eval_list) * (len(eval_list) - 1) // 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--spk", type=int, default=48)
    ap.add_argument("--train-utts", type=int, default=12)
    ap.add_argument("--eval-utts", type=int, default=4)
    ap.add_argument("--dur", type=float, default=4.0)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    n_trials = write_datadir(args.out, args.spk, args.train_utts, args.eval_utts, args.dur, args.seed)
    print(f"wrote {args.spk} spk x ({args.train_utts}+{args.eval_utts}) utts, "
          f"{n_trials} trials -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
