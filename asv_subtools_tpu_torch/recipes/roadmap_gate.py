"""ECAPA roadmap tricks ablation on the quality gate's corpus, through the
port (counterpart: recipes/roadmap_gate.py).

The reference's tricks table chains top-k -> sub-centre -> AAM -> LM
finetune -> MQMHA on VoxCeleb. This runs the same chain on the quality
gate's corpus with the gate's protocol: per-config cosine EER on
held-out utterances, seeded.

Configs (cumulative):
  baseline_aam    AAM m=0.2 (the quality gate's model)
  topk_subcenter  margin_softmax_v1, adapt_method=topk, sub_k=2
  mqmha           MQMHA (2 queries, 2 heads) pooling
  lm_finetune     large-margin finetune: the MQMHA phase's backbone with a
                  fresh head, m=0.5, 4 s chunks, lr 5e-5, no margin warm-up

The first three warm the margin up (MarginWarm(1, 2, -m, 0,
epoch_iter=steps // 4), lambda floored at 1e-3).

Usage: python -m asv_subtools_tpu_torch.recipes.roadmap_gate
         [--steps 400] [--lm-steps 120] [--spk 48] [--seed 7] [--cpu]
Runs on the CUDA card unless --cpu. Prints one JSON line per config plus
a summary line.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..device import resolve_device
from ..nn.loss import MarginWarm
from ..train import init_train_state
from . import _gate
from .gate_corpus import Renderer, make_speaker

MQMHA = {"num_q": 2, "num_head": 2}


def topk_head(n_spk: int, m: float = 0.2) -> dict:
    return {"method": "aam", "m": m, "s": 30.0, "sub_k": 2, "adapt_method": "topk", "topk": min(5, n_spk - 1)}


def transfer_backbone(state, init_state) -> None:
    """The LM finetune's start: ``init_state``'s backbone weights (not its
    running statistics, not its head) in place of ``state``'s
    (roadmap_gate.py:90-95)."""
    for k in state.params:
        if k.startswith("backbone."):
            state.params[k] = init_state.params[k].detach().clone()


def margin_warm(steps: int, m: float) -> MarginWarm:
    return MarginWarm(1, 2, offset_margin=-m, init_lambda=0.0, epoch_iter=max(1, steps // 4))


def run_config(label, speakers, render, *, steps, seed, loss_name, loss_params,
               pooling=None, pooling_params=None, chunk_s=2.0, lr=2e-3,
               margin_warm_on=True, init_state=None, eval_utts_per_spk=4,
               channels=128, batch_size=64, device=None):
    """Train one config from seed-0 weights (the backbone of ``init_state``
    when given) on batches drawn from ``default_rng(seed)`` and rendered by
    ``render``, evaluate on ``default_rng(seed + 1)``. -> (row, net, state,
    the loop's record)."""
    dev = resolve_device(device)
    n_spk = len(speakers)
    rng_np = np.random.default_rng(seed)
    net = _gate.gate_net(n_spk, channels, loss_name, loss_params, pooling, pooling_params, dev)
    tx, step = _gate.make_step(net, steps, lr=lr, warmup_steps=min(20, steps // 4))
    state = init_train_state(net, tx, dev)
    if init_state is not None:
        transfer_backbone(state, init_state)
    mw = margin_warm(steps, loss_params.get("m", 0.2)) if margin_warm_on else None
    gen = torch.Generator(device=dev).manual_seed(0)
    state, run = _gate.train_loop(
        step, state, _gate.speaker_batches(rng_np, speakers, steps, render, batch_size, chunk_s), gen,
        margin_warm=mw,
        progress=_gate.progress_line("  [" + label + "] step {step}: loss={loss:.3f} acc={accuracy:.3f}"))
    eval_rng = np.random.default_rng(seed + 1)
    items, labels = _gate.eval_items(eval_rng, speakers, eval_utts_per_spk, render)
    mat = _gate.extract(net, state, items)
    row = {
        "config": label,
        "eer_percent": round(_gate.cosine_eer(mat, labels), 2),
        "final_acc": round(run["last"].get("accuracy", 0.0), 3),
        "train_seconds": round(run["seconds"], 1),
    }
    print(json.dumps(row), flush=True)
    return row, net, state, run


def run(steps=400, lm_steps=120, n_spk=48, seed=7, channels=128, configs=None, device=None, workers=None):
    """The chain; ``configs`` picks a subset of the first three labels (the
    LM finetune runs when "mqmha" does). Prints the summary; returns it
    with "losses", each config's loss of each step."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    speakers = [make_speaker(rng) for _ in range(n_spk)]
    topk = topk_head(n_spk)
    chain = (
        ("baseline_aam", dict(loss_name="margin_softmax", loss_params=dict(_gate.AAM))),
        ("topk_subcenter", dict(loss_name="margin_softmax_v1", loss_params=topk)),
        ("mqmha", dict(loss_name="margin_softmax_v1", loss_params=topk, pooling="mqmha",
                       pooling_params=MQMHA)),
    )
    rows, losses = [], {}
    with Renderer(workers) as render:
        mq_state = None
        for label, kw in chain:
            if configs is not None and label not in configs:
                continue
            r, _, state, rec = run_config(label, speakers, render, steps=steps, seed=seed, channels=channels,
                                          device=dev, **kw)
            rows.append(r)
            losses[label] = rec["loss"]
            if label == "mqmha":
                mq_state = state
            del state
        if mq_state is not None:
            r, _, _, rec = run_config(
                "lm_finetune", speakers, render, steps=lm_steps, seed=seed + 10,
                loss_name="margin_softmax_v1", loss_params=topk_head(n_spk, m=0.5),
                pooling="mqmha", pooling_params=MQMHA, chunk_s=4.0, lr=5e-5, margin_warm_on=False,
                init_state=mq_state, channels=channels, device=dev)
            rows.append(r)
            losses["lm_finetune"] = rec["loss"]
    out = {"metric": "roadmap_gate", "rows": rows}
    print(json.dumps(out), flush=True)
    out["losses"] = losses
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--lm-steps", type=int, default=120)
    ap.add_argument("--spk", type=int, default=48)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    run(steps=args.steps, lm_steps=args.lm_steps, n_spk=args.spk, seed=args.seed,
        device="cpu" if args.cpu else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
