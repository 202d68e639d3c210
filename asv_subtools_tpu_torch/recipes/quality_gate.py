"""Regression-sensitive quality gate on the port (counterpart:
recipes/quality_gate.py).

The corpus is hard enough that the cosine EER lands in the 2-10% band:
speaker identity is carried by vocal-tract formant positions only, f0
ranges overlap across speakers, and every utterance gets a random channel
tilt and additive noise at 5-20 dB SNR (``gate_corpus``). An ECAPA-TDNN
C128 trains on it for 400 wave-input steps (B=64 x 2 s, bf16, K1 in the
step), then the held-out utterances' submean cosine EER is taken.

``--multi`` is the regression gate proper: a PAIRED 5-seed gate. Each
seed's EER is compared with its calibration value, and the gate holds
|mean delta| <= DELTA_BAND, with a wide absolute band on the mean. Its
smallest reliably detectable regression is about 0.5 pt EER, about 7%
relative.

Usage: python -m asv_subtools_tpu_torch.recipes.quality_gate
         [--steps 400] [--spk 48] [--channels 128] [--seed 7] [--multi]
         [--band LO HI] [--cpu]
Runs on the CUDA card unless --cpu. Prints one JSON line (a single seed:
"eer_percent", "band", "pass", ...; --multi: one line a seed, then
"eer_percent_mean", "per_seed", "mean_delta_vs_calibration", ...); exits
1 if out of band.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..device import resolve_device
from ..train import init_train_state
from . import _gate
from .gate_corpus import Renderer, make_speaker

# The JAX package's EERs of this gate on its own runs (400 steps, one
# seed each; recipes/quality_gate.py:111-116): the values the port is held
# to, not results of the port. Per-seed EER was deterministic there; the
# corpus seed moves it a lot (per-seed s = 1.28 over these 8 seeds), a
# change of the compute graph moves the same seed about +-0.4 pt. Hence
# the paired gate: the mean per-seed delta cancels the corpus difficulty
# (sigma about 0.4 / sqrt(5) = 0.18 over 5 seeds; band 2.5 sigma).
CALIBRATION = {7: 7.36, 8: 6.60, 9: 6.79, 10: 6.74, 11: 8.68,
               12: 9.42, 13: 6.27, 14: 5.56}
MULTI_SEEDS = (7, 8, 9, 10, 11)
DELTA_BAND = 0.45           # |mean(EER_seed - CALIBRATION[seed])| bound
MULTI_BAND = (5.5, 9.0)     # absolute sanity band on the k-seed mean
SINGLE_BAND = (4.8, 10.2)   # per-seed envelope +/- margin; smoke only


def corpus(seed: int, n_spk: int):
    """(rng, speakers): the generator of the run, after drawing the speakers."""
    rng = np.random.default_rng(seed)
    return rng, [make_speaker(rng) for _ in range(n_spk)]


def run_gate(steps=400, n_spk=48, channels=128, batch_size=64,
             eval_utts_per_spk=4, band=SINGLE_BAND, seed=7, device=None, workers=None):
    """One seed: train, extract the held-out utterances, cosine EER. Prints
    the JSON dict; returns it with "losses", the loss of each step."""
    dev = resolve_device(device)
    rng_np, speakers = corpus(seed, n_spk)
    net = _gate.gate_net(n_spk, channels, device=dev)
    tx, step = _gate.make_step(net, steps)
    state = init_train_state(net, tx, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    with Renderer(workers) as render:
        state, run = _gate.train_loop(
            step, state, _gate.speaker_batches(rng_np, speakers, steps, render, batch_size), gen,
            progress=_gate.progress_line("step {step}: loss={loss:.3f} acc={accuracy:.3f}"))
        items, labels = _gate.eval_items(rng_np, speakers, eval_utts_per_spk, render)
        mat = _gate.extract(net, state, items)
    eer_pct = _gate.cosine_eer(mat, labels)
    last = run["last"]
    ok = band[0] <= eer_pct <= band[1]
    out = {
        "metric": "quality_gate_eer",
        "eer_percent": round(eer_pct, 2),
        "band": list(band),
        "pass": bool(ok),
        "speakers": n_spk,
        "train_steps": steps,
        "final_loss": last.get("loss"),
        "final_acc": last.get("accuracy"),
        "train_seconds": round(run["seconds"], 1),
        "device": _gate.device_label(dev),
    }
    print(json.dumps(out), flush=True)
    out["losses"] = run["loss"]
    return out


def run_gate_multi(seeds=MULTI_SEEDS, band=MULTI_BAND,
                   delta_band=DELTA_BAND, **kw):
    """The paired gate: per-seed EER deltas against CALIBRATION; passes when
    |mean delta| <= delta_band and the mean EER lies in ``band``."""
    runs = [run_gate(seed=s, band=(0.0, 100.0), **kw) for s in seeds]
    eers = [r["eer_percent"] for r in runs]
    mean = float(np.mean(eers))
    deltas = [e - CALIBRATION[s] for s, e in zip(seeds, eers)
              if s in CALIBRATION]
    mean_delta = float(np.mean(deltas)) if deltas else 0.0
    ok = (band[0] <= mean <= band[1]) and abs(mean_delta) <= delta_band
    out = {
        "metric": "quality_gate_eer_mean",
        "eer_percent_mean": round(mean, 2),
        "per_seed": {s: e for s, e in zip(seeds, eers)},
        "mean_delta_vs_calibration": round(mean_delta, 3),
        "delta_band": delta_band,
        "band": list(band),
        "pass": bool(ok),
    }
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--spk", type=int, default=48)
    ap.add_argument("--channels", type=int, default=128)
    ap.add_argument("--seed", type=int, default=7,
                    help="corpus+train seed (single-seed smoke run)")
    ap.add_argument("--multi", action="store_true",
                    help="the real regression gate: mean over seeds "
                         f"{MULTI_SEEDS}, band {MULTI_BAND}")
    ap.add_argument("--band", type=float, nargs=2, default=None,
                    help="override pass band (default: the calibrated one)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    kw = dict(steps=args.steps, n_spk=args.spk, channels=args.channels,
              device="cpu" if args.cpu else None)
    if args.multi:
        mb = tuple(args.band) if args.band is not None else MULTI_BAND
        res = run_gate_multi(band=mb, **kw)
    else:
        if args.band is not None:
            kw["band"] = tuple(args.band)
        res = run_gate(seed=args.seed, **kw)
    return 0 if res["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
