"""VoxCeleb speaker-verification recipe through the port (counterpart:
recipes/voxceleb/run.py; parity: recipe/voxcelebSRC/runVoxcelebSRC.sh +
pytorch/launcher/runEcapaXvector_online.py).

    python -m asv_subtools_tpu_torch.recipes.voxceleb --data DATA [--exp EXP] [--trials TRIALS]

Stages (pick with --stage/--stop-stage like the reference):
  0  build egs from wav.scp/utt2spk (online pipeline, aug + chunks)
  1  train (ECAPA-C1024 + AAM sub-center/inter-topK, cyclic adamW, bf16,
     the fused fbank kernel inside the step)
  2  extract embeddings for train(cohort)/eval -> xvector ark/scp
  3  score --trials (needs stage 2's ark/scp): submean + length-norm
     cosine with AS-norm (top 300 over the first 3,000 sorted train
     vectors), enroll = test = the eval set; prints EER and minDCF. The
     cosine score matrices run on the device, the rest in f64 on the host

Point --data at a Kaldi-style directory tree:
  <data>/train/{wav.scp,utt2spk}
  <data>/eval/{wav.scp}
Runs on the CUDA card unless --device cpu.
"""

import argparse
import os
import sys
from typing import Dict, List, Optional

from ..utils.params import assign_params_dict


def apply_preset(params: Dict, preset: Dict) -> Dict:
    """Merge a recipes/configs/*.yaml preset over the ECAPA defaults.

    model/loss/optimizer/lr_schedule REPLACE wholesale (a recursive merge
    would leak ECAPA kwargs - `channels`, cyclic-LR keys - into the
    preset's classes); everything else merges recursively.
    """
    preset = dict(preset)
    for sect in ("model", "loss"):
        if sect in preset:
            params[sect] = preset.pop(sect)
    if "train" in preset:
        preset["train"] = dict(preset["train"])
        for sub in ("optimizer", "lr_schedule"):
            if sub in preset["train"]:
                params["train"][sub] = preset["train"].pop(sub)
    return assign_params_dict(params, preset, support_unknown=True)


def _epoch_iter(data: str, batch_size: int) -> int:
    with open(os.path.join(data, "train", "wav.scp")) as f:
        return max(1, sum(1 for _ in f) // batch_size)


def recipe_params(data: str, exp: str, *, epochs: int = 6, batch_size: int = 512, channels: int = 1024,
                  max_lr: float = 1e-3, step_size_up: int = 15000) -> Dict:
    """The recipe's parameters (recipes/voxceleb/run.py:80-130)."""
    return {
        "exp_dir": exp,
        "data": {
            "train_wav_scp": os.path.join(data, "train", "wav.scp"),
            "train_utt2spk": os.path.join(data, "train", "utt2spk"),
            "chunk_seconds": 2.015,
            "batch_size": batch_size,
            "speed_perturb": True,
            "spec_aug": True,
            "num_bins": 80,  # reference voxceleb recipes: 80/81-fbank
            # the host only decodes/augments waveforms; the fused fbank,
            # CMVN and SpecAugment run inside the train step
            "compute_feat": False,
        },
        "extract": {
            "mode": "wave",  # the fused fbank kernel for extraction too
            "batch": 32,
        },
        "model": {
            "name": "ecapa_tdnn",
            "params": {"channels": channels, "embd_dim": 192},
        },
        "loss": {
            "name": "margin_softmax_v1",
            "params": {
                "method": "aam", "m": 0.2, "s": 30.0,
                "sub_k": 2, "adapt_method": "topk", "topk": 5,
            },
        },
        "train": {
            "epochs": epochs,
            "optimizer": {"name": "adamW", "learning_rate": 1e-3, "weight_decay": 5e-5},
            "lr_schedule": {
                "name": "cyclic", "base_lr": 1e-8, "max_lr": max_lr,
                "step_size_up": step_size_up, "mode": "triangular2",
            },
            # epoch_iter from the actual dataset so the margin warm-up
            # (epochs 1-3) tracks real steps/epoch
            "margin_warm": {
                "start_epoch": 1, "end_epoch": 3,
                "offset_margin": -0.2, "init_lambda": 0.0,
                "epoch_iter": _epoch_iter(data, batch_size),
            },
        },
    }


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", required=True)
    ap.add_argument("--exp", default="exp/ecapa_c1024")
    ap.add_argument("--trials", required=False)
    ap.add_argument(
        "--config",
        help="recipes/configs/*.yaml preset merged over the ECAPA defaults "
        "(model/loss/train sections) - runs any ported family through the "
        "same pipeline",
    )
    ap.add_argument("--stage", type=int, default=0)
    ap.add_argument("--stop-stage", type=int, default=3)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--channels", type=int, default=1024)
    # cyclic-LR geometry: the preset step_size_up=15000 is tuned for
    # voxceleb2-scale runs (~2.1k steps/epoch); short runs must shrink it
    # or the LR never leaves the 1e-8 floor
    ap.add_argument("--max-lr", type=float, default=None)
    ap.add_argument("--step-size-up", type=int, default=None)
    # transformer model warmup: presets carry voxceleb-scale step counts;
    # small-corpus runs must shrink it with the LR geometry
    ap.add_argument("--model-warmup", type=int, default=None)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    max_lr = args.max_lr if args.max_lr is not None else 1e-3
    step_size_up = args.step_size_up if args.step_size_up is not None else 15000
    params = recipe_params(args.data, args.exp, epochs=args.epochs if args.epochs is not None else 6,
                           batch_size=args.batch_size if args.batch_size is not None else 512,
                           channels=args.channels, max_lr=max_lr, step_size_up=step_size_up)

    if args.config:
        from ..utils.params import load_yaml

        params = apply_preset(params, load_yaml(args.config))
        # explicit CLI scalars win over the preset (small-corpus runs need
        # their own batch/epoch/LR geometry regardless of model family)
        if args.batch_size is not None:
            params["data"]["batch_size"] = args.batch_size
        if args.epochs is not None:
            params["train"]["epochs"] = args.epochs
        if args.max_lr is not None or args.step_size_up is not None:
            old_sched = params["train"]["lr_schedule"].get("name")
            if old_sched != "cyclic":
                print(f"WARNING: --max-lr/--step-size-up replace the preset's '{old_sched}' schedule with cyclic",
                      file=sys.stderr)
            params["train"]["lr_schedule"] = {
                "name": "cyclic", "base_lr": 1e-8, "max_lr": max_lr,
                "step_size_up": step_size_up, "mode": "triangular2",
            }
    if args.model_warmup is not None:
        params["train"]["model_warmup_steps"] = args.model_warmup
    # margin warm-up tracks real steps/epoch for the FINAL batch size
    # (CLI or preset), not the default's
    if params["train"].get("margin_warm"):
        params["train"]["margin_warm"]["epoch_iter"] = _epoch_iter(args.data, int(params["data"]["batch_size"]))

    from ..launcher import Launcher

    launcher = Launcher(params, device=args.device)
    egs = launcher.build_egs()
    launcher.build_model()

    if args.stage <= 1 <= args.stop_stage:
        launcher.train(egs)
    if args.stage <= 2 <= args.stop_stage:
        for subset in ("train", "eval"):
            scp = os.path.join(args.data, subset, "wav.scp")
            if os.path.exists(scp):
                launcher.extract(scp, os.path.join(args.exp, f"xvector_{subset}"))
    if args.stage <= 3 <= args.stop_stage and args.trials:
        # recipes/voxceleb/run.py:176-190. Its speaker ids are hash(spk) %
        # 10**9, which Python salts per process; Launcher.score numbers the
        # speakers by sorted index instead. The cosine configuration never
        # reads the ids, so the result is the same.
        eval_scp = os.path.join(args.exp, "xvector_eval.scp")
        out = launcher.score(os.path.join(args.exp, "xvector_train.scp"), params["data"]["train_utt2spk"],
                             eval_scp, eval_scp, args.trials, process="submean-norm", classifier="cosine",
                             score_norm="asnorm", top_n=300, cohort_size=3000)
        print(out)


if __name__ == "__main__":
    main()
