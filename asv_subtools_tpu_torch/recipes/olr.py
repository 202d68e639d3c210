"""AP-OLR language-identification recipe through the port (counterpart:
recipes/olr/run.py; parity: recipe/ap-olr2020-baseline and
recipe/olr2021-baseline).

    python -m asv_subtools_tpu_torch.recipes.olr --data DATA [--exp EXP]

Language identification is the x-vector pipeline with language labels:
  0  build egs from wav.scp with utt2lang in the utt2spk role (online
     pipeline, host fbank, 3.0 s chunks)
  1  train the E-TDNN x-vector (extended_xvector, width 512) with the AM
     margin softmax (m 0.2), SGD 1e-2 on the warmR schedule (t_0 20000),
     B = 256
  2  extract embeddings of the train and eval lists -> xvector ark/scp
  3  logistic regression over the train embeddings, scored on the eval
     list against every language: prints Cavg and EER%

Point --data at a Kaldi-style directory tree:
  <data>/train/{wav.scp,utt2lang}
  <data>/eval/{wav.scp,utt2lang}
Runs on the CUDA card unless --device cpu. Stage 3 fits the regression
with sklearn (the reference's) unless --lr-solver lbfgs, which solves the
same objective with scipy (for machines without sklearn).
"""

import argparse
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


def recipe_params(data: str, exp: str, *, epochs: int = 6, batch_size: int = 256, chunk_seconds: float = 3.0,
                  width: int = 512, lr: float = 1e-2) -> Dict:
    """The recipe's parameters (recipes/olr/run.py:48-68)."""
    return {
        "exp_dir": exp,
        "data": {
            "train_wav_scp": os.path.join(data, "train", "wav.scp"),
            # utt2lang plays the utt2spk role: labels are languages
            "train_utt2spk": os.path.join(data, "train", "utt2lang"),
            "chunk_seconds": chunk_seconds,
            "batch_size": batch_size,
        },
        "model": {
            "name": "extended_xvector",
            "params": {"num_frame_channels": width, "embd_dim": width},
        },
        "loss": {"name": "margin_softmax", "params": {"method": "am", "m": 0.2}},
        "train": {
            "epochs": epochs,
            "optimizer": {"name": "sgd", "learning_rate": lr},
            "lr_schedule": {"name": "warmR", "base_lr": lr, "t_0": 20000},
        },
    }


def _utt2lang(path: str) -> Dict[str, str]:
    with open(path) as f:
        return dict(line.split()[:2] for line in f if line.strip())


def score_languages(data: str, exp: str, lr_solver: str = "sklearn") -> Dict[str, float]:
    """Stage 3 (recipes/olr/run.py:79-107): a logistic regression over the
    train embeddings, each eval embedding scored against every language;
    -> {"Cavg": min Cavg, "EER%": EER in percent}, unrounded."""
    from ..backend import compute_cavg, compute_eer, train_logistic_regression
    from ..io import read_vec_flt_scp

    train_embs = dict(read_vec_flt_scp(os.path.join(exp, "xvector_train.scp")))
    eval_embs = dict(read_vec_flt_scp(os.path.join(exp, "xvector_eval.scp")))
    u2l_train = _utt2lang(os.path.join(data, "train", "utt2lang"))
    u2l_eval = _utt2lang(os.path.join(data, "eval", "utt2lang"))
    langs = sorted(set(u2l_train.values()))
    l2i = {lang: i for i, lang in enumerate(langs)}
    xk = sorted(train_embs)
    clf = train_logistic_regression(np.stack([train_embs[k] for k in xk]),
                                    np.asarray([l2i[u2l_train[k]] for k in xk]), solver=lr_solver)
    ek = sorted(eval_embs)
    scores = clf.scores(np.stack([eval_embs[k] for k in ek]))
    pairs = []
    for i, k in enumerate(ek):
        true = l2i.get(u2l_eval.get(k, ""), -1)
        for j in range(len(langs)):
            pairs.append((j, true, float(scores[i, j])))
    _, min_cavg = compute_cavg(pairs, len(langs))
    flat = np.asarray([p[2] for p in pairs])
    lab = np.asarray([1 if p[0] == p[1] else 0 for p in pairs])
    eer, _ = compute_eer(flat, lab)
    return {"Cavg": float(min_cavg), "EER%": 100.0 * float(eer)}


def run(data: str, exp: str, *, stage: int = 0, stop_stage: int = 3, lr_solver: str = "sklearn",
        device: Any = None, **params: Any) -> Tuple[Any, Dict[str, Dict], Optional[Dict[str, float]]]:
    """Stages ``stage`` .. ``stop_stage`` with :func:`recipe_params`
    (``params`` its keywords) -> (the Launcher, stage 2's extraction
    stats by list, stage 3's result or None)."""
    from ..launcher import Launcher

    launcher = Launcher(recipe_params(data, exp, **params), device=device)
    egs = launcher.build_egs()
    launcher.build_model()
    if stage <= 1 <= stop_stage:
        launcher.train(egs)
    extracted = {}
    if stage <= 2 <= stop_stage:
        for subset in ("train", "eval"):
            scp = os.path.join(data, subset, "wav.scp")
            if os.path.exists(scp):
                extracted[subset] = launcher.extract(scp, os.path.join(exp, f"xvector_{subset}"))
    out = score_languages(data, exp, lr_solver) if stage <= 3 <= stop_stage else None
    return launcher, extracted, out


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", required=True)
    ap.add_argument("--exp", default="exp/olr_xvector")
    ap.add_argument("--stage", type=int, default=0)
    ap.add_argument("--stop-stage", type=int, default=3)
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--chunk-seconds", type=float, default=3.0)
    ap.add_argument("--width", type=int, default=512, help="frame-channel width (shrink for smoke corpora)")
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--lr-solver", default="sklearn", choices=("sklearn", "lbfgs"))
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    _, _, out = run(args.data, args.exp, stage=args.stage, stop_stage=args.stop_stage, lr_solver=args.lr_solver,
                    device=args.device, epochs=args.epochs, batch_size=args.batch_size,
                    chunk_seconds=args.chunk_seconds, width=args.width, lr=args.lr)
    if out is not None:
        print({"Cavg": round(out["Cavg"], 4), "EER%": round(out["EER%"], 2)})


if __name__ == "__main__":
    main()
