"""Domain-adaptation end-to-end gate on the port: the reference's SRE
use-case shape (counterpart: recipes/adaptation_gate.py).

  1. train an ECAPA-TDNN C128 on SOURCE-domain synthetic speakers (the
     quality gate's corpus: full band, mild tilt, 5-20 dB SNR);
  2. estimate a PLDA on source-domain embeddings of the train speakers;
  3. evaluate on UNSEEN speakers in a TARGET domain (telephone-like
     300-3400 Hz bandpass, a stronger tilt, 0-12 dB noise), where the
     source PLDA degrades;
  4. adapt and re-score: Kaldi-unsupervised, CORAL and CORAL+ use the
     target-domain set unlabeled; LIP-Reg and CIP-Reg also get the small
     labeled in-domain PLDA.

Gate: the best adaptation must beat the unadapted source PLDA on the
target-domain EER.

Usage: python -m asv_subtools_tpu_torch.recipes.adaptation_gate
         [--steps 400] [--cpu]
Runs on the CUDA card unless --cpu. Prints one JSON line; exits 1 if the
gate fails.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Tuple

import numpy as np
import torch

from ..backend import (
    PldaStats,
    TwoCovPlda,
    adapt_plda_cip_reg,
    adapt_plda_coral,
    adapt_plda_coral_plus,
    adapt_plda_lip_reg,
    adapt_plda_unsupervised,
    compute_eer,
    estimate_plda,
    length_norm,
    plda_score_trials,
)
from ..device import resolve_device
from ..train import init_train_state
from . import _gate
from .gate_corpus import Renderer, make_speaker


def corpus(seed: int, n_train_spk: int, n_adapt_spk: int, n_eval_spk: int):
    """(rng, train, adapt and eval speakers), drawn in that order."""
    rng = np.random.default_rng(seed)
    train_spk = [make_speaker(rng) for _ in range(n_train_spk)]
    adapt_spk = [make_speaker(rng) for _ in range(n_adapt_spk)]
    eval_spk = [make_speaker(rng) for _ in range(n_eval_spk)]
    return rng, train_spk, adapt_spk, eval_spk


def score_table(x_src, y_src, x_adapt, y_adapt, x_eval, y_eval) -> Tuple[Dict[str, float], str, bool]:
    """Target-domain EERs (percent) of cosine, the source PLDA, each
    adaptation and the in-domain PLDA alone, all on embeddings
    length-normed about the source mean; -> (table, best adaptation,
    whether it beats the source PLDA)."""
    src_mean = x_src.mean(axis=0)
    ln = lambda v: length_norm(v - src_mean)
    x_src_n, x_adapt_n, x_eval_n = ln(x_src), ln(x_adapt), ln(x_eval)

    plda = estimate_plda(PldaStats.from_vectors(x_src_n, y_src), 10)
    iu, same = _gate.trial_pairs(y_eval)

    def eer_of(scores_mat):
        e, _ = compute_eer(np.asarray(scores_mat)[iu], same)
        return 100.0 * e

    def plda_eer(p):
        return eer_of(plda_score_trials(p, x_eval_n, x_eval_n))

    results = {"cosine": eer_of(x_eval_n @ x_eval_n.T), "plda_source": plda_eer(plda)}
    results["plda_aplda"] = plda_eer(adapt_plda_unsupervised(plda, x_adapt_n))
    two_out = TwoCovPlda.from_scoring_form(plda)
    for name, fn in (("coral", adapt_plda_coral), ("coral_plus", adapt_plda_coral_plus)):
        results[f"plda_{name}"] = plda_eer(fn(two_out, x_adapt_n).to_scoring_form())
    plda_in = estimate_plda(PldaStats.from_vectors(x_adapt_n, y_adapt), 10)
    two_in = TwoCovPlda.from_scoring_form(plda_in)
    results["plda_indomain_only"] = plda_eer(plda_in)
    results["plda_lip_reg"] = plda_eer(adapt_plda_lip_reg(two_out, two_in).to_scoring_form())
    results["plda_cip_reg"] = plda_eer(adapt_plda_cip_reg(two_out, two_in, x_adapt_n).to_scoring_form())

    best_name, best = min(
        ((k, v) for k, v in results.items()
         if k.startswith("plda_") and k not in ("plda_source", "plda_indomain_only")),
        key=lambda kv: kv[1],
    )
    return results, best_name, bool(best < results["plda_source"])


def run_gate(steps=400, n_train_spk=48, n_adapt_spk=24, n_eval_spk=24,
             channels=128, batch_size=64, seed=11, device=None, workers=None):
    """Train, extract the three sets, score the table. Prints the JSON
    dict; returns it with "losses", the loss of each step."""
    dev = resolve_device(device)
    rng_np, train_spk, adapt_spk, eval_spk = corpus(seed, n_train_spk, n_adapt_spk, n_eval_spk)
    net = _gate.gate_net(n_train_spk, channels, device=dev)
    tx, step = _gate.make_step(net, steps)
    state = init_train_state(net, tx, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    with Renderer(workers) as render:
        state, run = _gate.train_loop(
            step, state, _gate.speaker_batches(rng_np, train_spk, steps, render, batch_size), gen,
            progress=_gate.progress_line("step {step}: loss={loss:.3f} acc={accuracy:.3f}"))

        def extract_set(tag, speakers, utts_per_spk, domain):
            items, labels = _gate.eval_items(rng_np, speakers, utts_per_spk, render, tag=tag,
                                             kind="target" if domain == "target" else "synth")
            return _gate.extract(net, state, items), labels

        # backend training: the train speakers, fresh source-domain utterances
        x_src, y_src = extract_set("b", train_spk, 8, "source")
        # adaptation set: unseen speakers, target domain (labels only for
        # the LIP/CIP interpolation variants)
        x_adapt, y_adapt = extract_set("a", adapt_spk, 6, "target")
        # evaluation: other unseen speakers, target domain
        x_eval, y_eval = extract_set("e", eval_spk, 6, "target")

    results, best_name, ok = score_table(x_src, y_src, x_adapt, y_adapt, x_eval, y_eval)
    out = {
        "metric": "adaptation_gate",
        "eer_percent": {k: round(v, 2) for k, v in results.items()},
        "best_adaptation": best_name,
        "improves": ok,
        "train_steps": steps,
        "train_seconds": round(run["seconds"], 1),
        "device": _gate.device_label(dev),
    }
    print(json.dumps(out), flush=True)
    out["losses"] = run["loss"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    res = run_gate(steps=args.steps, device="cpu" if args.cpu else None)
    return 0 if res["improves"] else 1


if __name__ == "__main__":
    sys.exit(main())
