"""Anti-spoofing end-to-end gate on the port: OCSoftmax training -> CM EER
and min t-DCF (counterpart: recipes/antispoof_gate.py).

Bona fide are the quality gate's formant voices; spoofs are three
synthetic attack families over the same voices (``gate_corpus.spoof_utt``:
mu-law companding, hard clipping, a 4 kHz bandwidth round trip). An
ECAPA-TDNN C128 trains with the OCSoftmax head ("paper" convention, Zhang
et al. 2021 eq. 8) on batches resampled each step from a pool of 480
bona-fide/spoof pairs drawn once. The countermeasure score is the cosine
of an embedding with the head's centre. The tandem min t-DCF takes its
ASV scores from calibrated Gaussians (a stand-in: the gate trains no ASV
system).

Usage: python -m asv_subtools_tpu_torch.recipes.antispoof_gate
         [--steps 600] [--cpu]
Runs on the CUDA card unless --cpu. Prints one JSON line; exits 1 if the
CM EER leaves the band (0.5, 20).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..backend import compute_eer, compute_min_tdcf
from ..device import resolve_device
from ..train import init_train_state
from . import _gate
from .gate_corpus import Renderer, make_speaker

OCSOFTMAX = {"r_real": 0.9, "r_fake": 0.2, "alpha": 20.0, "convention": "paper"}
POOL_PAIRS = 480
BAND = (0.5, 20.0)


def corpus(seed: int, n_spk: int, render, chunk_s: float = _gate.CHUNK_S, pairs: int = POOL_PAIRS):
    """(rng, speakers, pool_x [2 pairs, S], pool_y): the pre-drawn pool, a
    bona-fide wave (label 1) and then its spoof (label 0) per pair
    (antispoof_gate.py:118-130)."""
    rng = np.random.default_rng(seed)
    speakers = [make_speaker(rng) for _ in range(n_spk)]
    waits = [render.submit(rng, "spoof_pair", speakers[rng.integers(0, n_spk)], chunk_s)
             for _ in range(pairs)]
    pool_x, pool_y = [], []
    for wait in waits:
        bona, spoof = wait()
        pool_x += [bona, spoof]
        pool_y += [1, 0]
    return rng, speakers, np.stack(pool_x), np.asarray(pool_y, np.int32)


def pool_batches(rng, pool_x, pool_y, steps: int, batch_size: int = _gate.BATCH):
    """Per step, ``batch_size`` rows drawn from the pool with replacement."""
    for _ in range(steps):
        idx = rng.integers(0, len(pool_x), batch_size)
        yield pool_x[idx], pool_y[idx]


def eval_items(rng, speakers, render):
    """8 utterances a speaker of 2.5-3.5 s: even ones bona fide, odd ones
    spoofed by attack u % 3. -> ([(key, wait)], labels)."""
    items, labels = [], []
    for s, spk in enumerate(speakers):
        for u in range(8):
            dur = rng.uniform(2.5, 3.5)
            if u % 2 == 0:
                items.append((f"s{s}u{u}b", render.submit(rng, "synth", spk, dur)))
                labels.append(1)
            else:
                items.append((f"s{s}u{u}a", render.submit(rng, "spoofed", spk, dur, u % 3)))
                labels.append(0)
    return items, np.asarray(labels)


def cm_scores(mat: np.ndarray, center: np.ndarray) -> np.ndarray:
    """Cosine of each embedding with the centre (paper convention: bona
    fide above r_real)."""
    mat = mat.astype(np.float32).copy()
    center = np.array(center, np.float32)
    mat /= np.linalg.norm(mat, axis=-1, keepdims=True) + 1e-9
    center /= np.linalg.norm(center) + 1e-9
    return mat @ center


def tandem_min_tdcf(scores: np.ndarray, labels: np.ndarray) -> float:
    """min t-DCF of the CM scores against the Gaussian ASV stand-in drawn
    from ``default_rng(0)``: targets N(2, 1), nontargets N(-2, 1), spoofs
    N(0.5, 1.5), 2,000 each."""
    n_asv = 2000
    g = np.random.default_rng(0)
    asv_scores = np.concatenate([
        g.normal(2.0, 1.0, n_asv),
        g.normal(-2.0, 1.0, n_asv),
        g.normal(0.5, 1.5, n_asv),
    ])
    asv_labels = np.concatenate([
        np.ones(n_asv, np.int64),
        np.zeros(n_asv, np.int64),
        -np.ones(n_asv, np.int64),
    ])
    return float(compute_min_tdcf(asv_scores, asv_labels, scores, labels))


def run_gate(steps=600, n_spk=24, channels=128, batch_size=64, band=BAND, seed=11, pairs=POOL_PAIRS, device=None,
             workers=None):
    """Train on the pool, score the evaluation set against the centre.
    Prints the JSON dict; returns it with "losses", the loss of each step."""
    dev = resolve_device(device)
    net = _gate.gate_net(2, channels, "ocsoftmax", OCSOFTMAX, device=dev)
    tx, step = _gate.make_step(net, steps)
    state = init_train_state(net, tx, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    with Renderer(workers) as render:
        rng_np, speakers, pool_x, pool_y = corpus(seed, n_spk, render, pairs=pairs)
        state, run = _gate.train_loop(step, state, pool_batches(rng_np, pool_x, pool_y, steps, batch_size), gen,
                                      progress=_gate.progress_line("step {step}: loss={loss:.4f}"))
        items, labels = eval_items(rng_np, speakers, render)
        mat = _gate.extract(net, state, items)
    scores = cm_scores(mat, state.params["loss.center"].float().cpu().numpy()[0])
    eer, _ = compute_eer(scores, labels)
    eer_pct = 100.0 * eer
    ok = band[0] <= eer_pct <= band[1]
    out = {
        "metric": "antispoof_gate",
        "cm_eer_percent": round(eer_pct, 2),
        "min_tdcf": round(tandem_min_tdcf(scores, labels), 4),
        "band": list(band),
        "pass": bool(ok),
        "train_steps": steps,
        "final_loss": run["last"].get("loss"),
        "train_seconds": round(run["seconds"], 1),
        "device": _gate.device_label(dev),
    }
    print(json.dumps(out), flush=True)
    out["losses"] = run["loss"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    res = run_gate(steps=args.steps, device="cpu" if args.cpu else None)
    return 0 if res["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
