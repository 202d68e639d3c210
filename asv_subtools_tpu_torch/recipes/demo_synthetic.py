"""End-to-end demo on the card (counterpart: recipes/demo_synthetic.py):
synthetic speakers -> wave-input bf16 training (the fused fbank kernel
inside the train step) -> bucketed wave-mode extraction -> submean cosine
and AS-norm scoring -> EER and minDCF. Prints a JSON summary.

The speakers are harmonic-stack voices (a distinct f0 and harmonic
weights) with additive noise (``gate_corpus.make_demo_speaker``,
``synth_demo_utt``), so the task is learnable but not trivial.

Usage: python -m asv_subtools_tpu_torch.recipes.demo_synthetic [--cpu]
Runs on the CUDA card unless --cpu.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Tuple

import numpy as np
import torch

from ..backend import asnorm, compute_eer, compute_min_dcf, cosine_score_matrix
from ..device import resolve_device
from ..train import init_train_state
from . import _gate
from .gate_corpus import Renderer, make_demo_speaker


def corpus(seed: int, n_spk: int):
    rng = np.random.default_rng(seed)
    return rng, [make_demo_speaker(rng) for _ in range(n_spk)]


def cohort_items(rng, render, n: int = 128):
    """A fresh cohort: per utterance a new speaker, then 3 s of its voice."""
    items = []
    for i in range(n):
        spk = make_demo_speaker(rng)
        items.append((f"c{i}", render.submit(rng, "demo", spk, 3.0)))
    return items


def demo_scores(mat: np.ndarray, labels: np.ndarray, cohort: np.ndarray) -> Tuple[float, float, float]:
    """(EER, minDCF at p_target 0.05, AS-norm EER at top 40) of the submean
    cosine scores. The cohort is shifted by the mean of the already
    centred evaluation set, as demo_synthetic.py:131 does (a shift of
    rounding size)."""
    mat = mat - mat.mean(axis=0)
    scores = cosine_score_matrix(torch.from_numpy(mat), torch.from_numpy(mat)).numpy()
    iu, same = _gate.trial_pairs(labels)
    eer, _ = compute_eer(scores[iu], same)
    dcf, _ = compute_min_dcf(scores[iu], same, p_target=0.05)
    coh_scores = cosine_score_matrix(torch.from_numpy(mat), torch.from_numpy(cohort - mat.mean(axis=0))).numpy()
    normed = asnorm(scores, coh_scores, coh_scores, top_n=40)
    eer_asnorm, _ = compute_eer(normed[iu], same)
    return float(eer), float(dcf), float(eer_asnorm)


def run(n_spk=64, steps=300, batch_size=64, channels=128, seed=7, cohort_size=128, device=None, workers=None):
    """Train, extract, score. Prints the JSON summary; returns it with
    "losses", the loss of each step."""
    dev = resolve_device(device)
    rng_np, speakers = corpus(seed, n_spk)
    net = _gate.gate_net(n_spk, channels, device=dev)
    tx, step = _gate.make_step(net, steps)
    state = init_train_state(net, tx, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    with Renderer(workers) as render:
        state, run_ = _gate.train_loop(
            step, state, _gate.speaker_batches(rng_np, speakers, steps, render, batch_size, kind="demo"), gen,
            report_every=50,
            progress=_gate.progress_line("step {step}: loss={loss:.3f} acc={accuracy:.3f}", sys.stdout))
        # held-out utterances of the same speakers
        items, labels = _gate.eval_items(rng_np, speakers, 4, render, kind="demo")
        t0 = time.time()
        mat = _gate.extract(net, state, items)
        extract_s = time.time() - t0
        cohort = _gate.extract(net, state, cohort_items(rng_np, render, cohort_size))
    eer, dcf, eer_asnorm = demo_scores(mat, labels, cohort)
    last = run_["last"]
    out = {
        "speakers": n_spk,
        "train_steps": steps,
        "train_seconds": round(run_["seconds"], 1),
        "final_loss": last.get("loss"),
        "eval_utts": len(items),
        "extract_seconds": round(extract_s, 2),
        "eer_percent": round(100 * eer, 2),
        "eer_asnorm_percent": round(100 * eer_asnorm, 2),
        "min_dcf_p05": round(dcf, 3),
        "device": _gate.device_label(dev),
    }
    print(json.dumps(out), flush=True)
    out["losses"] = run_["loss"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    run(device="cpu" if args.cpu else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
