"""RepVGG deploy gate on the port: train -> reparameterize -> serve the
deployed model (counterpart: recipes/repvgg_deploy_gate.py).

RepVGG trains with multi-branch blocks and deploys with every block folded
to one conv. This gate trains RepVggXvector (base 16, embedding 64) for 25
epochs through the port's Launcher on the corpus that ``synth_datadir``
writes, folds the trunk (``deploy_repvgg_xvector``, which runs
``repvgg_model_convert``), extracts the eval list with both the train
shape and the deployed model, and requires a mean embedding cosine above
0.999 and EERs within 0.5 pt of each other.

The host features come from the native C++ front end
(``feat_backend="native"``), as in the JAX gate.

Usage: python -m asv_subtools_tpu_torch.recipes.repvgg_deploy_gate
         [--data DIR] [--exp DIR] [--epochs 25] [--cpu]
Without --data the corpus is written at synth_datadir's defaults into a
temporary directory. Runs on the CUDA card unless --cpu. Prints a JSON
line per shape, then the comparison; exits 1 if a check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..data import WavEgsXvector
from ..extract import ExtractConfig, Extractor
from ..launcher import Launcher
from ..models import deploy_repvgg_xvector
from . import _gate
from .gate_corpus import Renderer

MIN_COSINE = 0.999
MAX_EER_GAP = 0.5


def gate_params(data: str, exp: str, epochs: int = 25) -> Dict[str, Any]:
    """The Launcher params of repvgg_deploy_gate.py:25-49, with the host
    features from the native front end."""
    return {
        "exp_dir": exp,
        "data": {
            "train_wav_scp": f"{data}/train/wav.scp",
            "train_utt2spk": f"{data}/train/utt2spk",
            "chunk_seconds": 2.0, "batch_size": 64,
            "num_bins": 80, "shuffle_buffer": 64,
            "feat_backend": "native",
        },
        "model": {"name": "repvgg_xvector",
                  "params": {"base_channels": 16, "embd_dim": 64}},
        "loss": {"name": "margin_softmax_v1",
                 "params": {"method": "aam", "m": 0.2, "sub_k": 2,
                            "adapt_method": "topk", "topk": 5}},
        "train": {"epochs": epochs,
                  "optimizer": {"name": "adamW", "learning_rate": 1.5e-3},
                  "lr_schedule": {"name": "cyclic", "base_lr": 1e-5,
                                  "max_lr": 1.5e-3, "step_size_up": 150},
                  "margin_warm": {"start_epoch": 1, "end_epoch": 3,
                                  "offset_margin": -0.2, "init_lambda": 0.0,
                                  "epoch_iter": 12},
                  "report_interval": 60},
    }


def score(embed_fn, items, label: str, device) -> tuple:
    """Embeddings of the eval list and their submean cosine EER (percent)."""
    ex = Extractor(embed_fn, ExtractConfig(buckets=(800,), default_batch=32), device=device)
    embs = ex.extract_all(iter(items))
    keys = [k for k, _ in items]
    eer = _gate.cosine_eer(np.stack([embs[k] for k in keys]), np.asarray([k.split("-")[0] for k in keys]))
    print(json.dumps({"config": label, "eer_percent": round(eer, 2)}), flush=True)
    return embs, eer


def run_gate(data: str, exp: str, epochs: int = 25, device: Any = None) -> Dict[str, Any]:
    """Train, fold, extract both shapes; -> the comparison line (printed),
    with the Launcher's losses an epoch and the training's wall time."""
    launcher = Launcher(gate_params(data, exp, epochs), device=device)
    egs = launcher.build_egs()
    launcher.build_model()
    t0 = time.time()
    state = launcher.train(egs)
    train_s = time.time() - t0

    backbone = launcher.net.backbone
    tensors = {k[len("backbone."):]: v for k, v in {**state.params, **state.batch_stats}.items()
               if k.startswith("backbone.")}

    def embed_train(x, mask):
        backbone.eval()
        return torch.func.functional_call(backbone, tensors, (x, mask))

    deployed = deploy_repvgg_xvector(backbone, tensors).eval()

    def embed_deploy(x, mask):
        return deployed(x, mask)

    items = list(iter(WavEgsXvector(f"{data}/eval/wav.scp", feat_opts=launcher.feat_opts,
                                    feat_backend="native", workers=4)))
    e_train, eer_t = score(embed_train, items, "repvgg_train_shape", launcher.device)
    e_dep, eer_d = score(embed_deploy, items, "repvgg_deploy_reparam", launcher.device)
    cos = float(np.mean([
        float(np.dot(e_train[k], e_dep[k]) /
              (np.linalg.norm(e_train[k]) * np.linalg.norm(e_dep[k]) + 1e-9))
        for k in e_train
    ]))
    out = {"deploy_vs_train_mean_cosine": round(cos, 6), "eer_train": eer_t, "eer_deploy": eer_d,
           "train_seconds": round(train_s, 1)}
    print(json.dumps(out), flush=True)
    out["losses"] = [s["metrics"].get("loss") for s in launcher.epoch_stats]
    return out


def check(out: Dict[str, Any]) -> None:
    """The gate's two assertions (repvgg_deploy_gate.py:109-110)."""
    cos, eer_t, eer_d = out["deploy_vs_train_mean_cosine"], out["eer_train"], out["eer_deploy"]
    if not cos > MIN_COSINE:
        raise AssertionError(cos)
    if not abs(eer_t - eer_d) < MAX_EER_GAP:
        raise AssertionError((eer_t, eer_d))


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default=None, help="a synth_datadir corpus (default: write one)")
    ap.add_argument("--exp", default=None, help="the experiment directory (default: a temporary one)")
    ap.add_argument("--epochs", type=int, default=25)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        data = args.data
        if data is None:
            from .synth_datadir import write_datadir

            data = os.path.join(tmp, "data")
            with Renderer() as render:
                write_datadir(data, render=render)
        out = run_gate(data, args.exp or os.path.join(tmp, "exp"), args.epochs, "cpu" if args.cpu else None)
    check(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
