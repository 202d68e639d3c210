"""NaN-batch forensics: dump the batch of a skipped step and replay it
(counterpart: asv_subtools_tpu/train/debug.py; parity: the reference's
nan_debug mode, trainer_online.py:232-300).

The train step already keeps the old state on a non-finite loss or
gradient norm; ``Trainer(nan_debug_dir=...)`` also writes the batch, the
weights and the metrics of each such step here, for an offline replay.
The dump is a pickle of numpy arrays: the weights and BatchNorm buffers
keyed by the net's state_dict names, the batch keyed as the step took it.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..device import resolve_device


def _to_numpy(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def dump_nan_batch(directory: str, state, batch: Dict, metrics: Dict, step: Optional[int] = None) -> str:
    """Write ``nan_batch_step{step}.pkl`` into ``directory``: the step, the
    batch, the state's weights and BatchNorm buffers (numpy) and the
    metrics (floats); -> its path. ``step`` defaults to the state's
    counter (a read of the card)."""
    os.makedirs(directory, exist_ok=True)
    step = step if step is not None else int(state.step)
    path = os.path.join(directory, f"nan_batch_step{step}.pkl")
    payload = {
        "step": step,
        "batch": _to_numpy(batch),
        "params": _to_numpy(state.params),
        "batch_stats": _to_numpy(state.batch_stats),
        "metrics": {k: float(v) for k, v in metrics.items()},
    }
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    return path


def load_nan_batch(path: str) -> Dict:
    with open(path, "rb") as f:
        return pickle.load(f)


def _all_finite(a: Any) -> bool:
    return bool(np.all(np.isfinite(np.asarray(a))))


def replay_nan_batch(path: str, net: nn.Module, generator: Optional[torch.Generator] = None,
                     device: Any = None) -> Dict:
    """The dumped batch through ``net`` (a SpeakerNet: (loss, logits,
    embedding)) in train mode on the dumped weights, on ``device`` (the
    CUDA card unless ``device="cpu"``), with dropout drawn from
    ``generator``; -> the loss and which of the loss, logits, embedding,
    input and weights are finite, for localisation. The batch is fed to
    the net as it was dumped: feature batches (a wave-input step's dump
    holds the waves)."""
    payload = load_nan_batch(path)
    dev = resolve_device(device)

    def tensor(a):
        if isinstance(a, dict):
            return {k: tensor(v) for k, v in a.items()}
        t = torch.from_numpy(np.asarray(a)).to(dev)
        return t.long() if not t.is_floating_point() and t.dtype != torch.bool else t

    batch = payload["batch"]
    tensors = {k: tensor(v) for k, v in {**payload["params"], **payload["batch_stats"]}.items()}
    net.to(dev).train()
    kwargs = {"mask": tensor(batch["mask"])} if batch.get("mask") is not None else {}
    if generator is not None:
        kwargs["generator"] = generator
    with torch.no_grad():
        loss, logits, emb = torch.func.functional_call(net, tensors, (tensor(batch["x"]), tensor(batch["y"])), kwargs)
    loss = float(loss)
    return {
        "loss": loss,
        "loss_finite": bool(np.isfinite(loss)),
        "logits_finite": bool(torch.isfinite(logits).all()),
        "embedding_finite": bool(torch.isfinite(emb).all()),
        "x_finite": _all_finite(batch["x"]),
        "params_finite": all(_all_finite(p) for p in payload["params"].values()),
    }
