"""Checkpoint / resume (counterpart: asv_subtools_tpu/train/checkpoint.py;
parity: trainer_online.py:113-196 save_model/resume).

Layout as in the JAX package:
    <dir>/<epoch>.params               - torch.save of {params, batch_stats,
                                         step[, opt_state]}
    <dir>/checkpoint_info/<epoch>.yaml - epoch / step / metrics sidecar
    <dir>/final.params                 - symlink to the last epoch

The payload holds plain dicts of CPU tensors and ints, so
``torch.load(path, weights_only=True)`` reads it. The sidecar is written
as JSON text, which is valid YAML: a YAML reader takes it, and writing it
needs no YAML library. Resume restores params and batch_stats, and the
optimizer state only when asked (the reference skips it,
trainer_online.py:125-130). The optimizer state of an FD run is the pair
(main, adversary), saved and restored as a tuple. Transfer learning copies whole top-level
subtrees by name like framework.py:133-143's transform_keys: the port's
state_dict prefixes ``backbone.`` and ``loss.`` stand for the JAX trees
``params["backbone"]`` and ``params["loss"]``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Sequence

import torch

from ..device import resolve_device
from .trainer import TrainState


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, tuple):  # FD's (main, adversary) optimizer states
        return tuple(_to_cpu(v) for v in tree)
    return tree.detach().cpu()


def save_checkpoint(directory: str, state: TrainState, epoch: Any, *, info: Optional[Dict] = None,
                    save_optimizer: bool = True) -> str:
    """Write ``<directory>/<epoch>.params`` and its sidecar, and point
    ``final.params`` at it. ``info`` holds floats and ints (the epoch's
    metrics). Returns the checkpoint's path."""
    os.makedirs(directory, exist_ok=True)
    payload = {"params": _to_cpu(state.params), "batch_stats": _to_cpu(state.batch_stats),
               "step": int(state.step)}
    if save_optimizer:
        payload["opt_state"] = _to_cpu(state.opt_state)
    path = os.path.join(directory, f"{epoch}.params")
    torch.save(payload, path)
    info_dir = os.path.join(directory, "checkpoint_info")
    os.makedirs(info_dir, exist_ok=True)
    with open(os.path.join(info_dir, f"{epoch}.yaml"), "w") as f:
        json.dump({"epoch": epoch, "step": payload["step"], **(info or {})}, f, indent=1)
        f.write("\n")
    final = os.path.join(directory, "final.params")
    if os.path.basename(path) != "final.params":
        if os.path.islink(final) or os.path.exists(final):
            os.remove(final)
        os.symlink(os.path.basename(path), final)
    return path


def read_checkpoint_info(path: str) -> Dict:
    """The sidecar of the checkpoint at ``path`` (``<dir>/<epoch>.params``)."""
    directory, name = os.path.split(os.path.realpath(path))
    with open(os.path.join(directory, "checkpoint_info", name[: -len(".params")] + ".yaml")) as f:
        return json.load(f)


def _restore_like(template: Any, data: Any, what: str) -> Any:
    """``data``'s tensors on ``template``'s devices and types; the key sets
    and shapes must match."""
    if isinstance(template, dict):
        if not isinstance(data, dict) or set(template) != set(data):
            missing = sorted(set(template) - set(data)) if isinstance(data, dict) else "all"
            extra = sorted(set(data) - set(template)) if isinstance(data, dict) else []
            raise ValueError(f"checkpoint {what} do not match the state: missing {missing}, unexpected {extra}")
        return {k: _restore_like(template[k], data[k], what) for k in template}
    if isinstance(template, tuple):
        if not isinstance(data, (tuple, list)) or len(data) != len(template):
            raise ValueError(f"checkpoint {what} do not match the state: {len(template)} optimizer states expected")
        return tuple(_restore_like(t, d, what) for t, d in zip(template, data))
    if tuple(data.shape) != tuple(template.shape):
        raise ValueError(f"checkpoint {what}: shape {tuple(data.shape)} != {tuple(template.shape)}")
    return data.to(device=template.device, dtype=template.dtype)


def load_checkpoint(path: str, state: Optional[TrainState] = None, *, restore_optimizer: bool = False,
                    device: Any = None):
    """Load a checkpoint. With a template ``state``, returns a new
    TrainState on the template's device: params, batch_stats and the step
    from the file, the optimizer state from the file only if asked (the
    reference default is not to). Without one, returns the payload with
    its tensors on ``device`` (the CUDA card unless ``device="cpu"``)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if state is None:
        dev = resolve_device(device)
        return {k: v if k == "step" else _to_device(v, dev) for k, v in payload.items()}
    new = TrainState(
        step=torch.tensor(int(payload.get("step", 0)), dtype=torch.int32).to(state.step.device),
        params=_restore_like(state.params, payload["params"], "params"),
        batch_stats=_restore_like(state.batch_stats, payload["batch_stats"], "batch_stats"),
        opt_state=state.opt_state)
    if restore_optimizer and "opt_state" in payload:
        new.opt_state = _restore_like(state.opt_state, payload["opt_state"], "optimizer state")
    return new


def _to_device(tree: Any, dev: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_device(v, dev) for v in tree)
    return tree.to(dev)


def load_transfer(params: Dict[str, torch.Tensor], checkpoint_path: str, *,
                  include: Optional[Sequence[str]] = None, exclude: Optional[Sequence[str]] = None,
                  rename: Optional[Dict[str, str]] = None) -> Dict[str, torch.Tensor]:
    """Transfer-learning load: copy matching top-level subtrees by name.

    ``params`` is a TrainState's params (state_dict names); a subtree is
    the set of names under one top-level prefix (``backbone``, ``loss``).
    ``include`` / ``exclude`` pick subtrees; ``rename`` maps a
    checkpoint's top-level name to the target's (parity:
    load_transform_state_dict + transform_keys, reference
    framework.py:133-143). A copied subtree must match the target's names
    and shapes; the tensors keep the target's device and type."""
    src: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, value in torch.load(checkpoint_path, map_location="cpu", weights_only=True)["params"].items():
        top, _, rest = key.partition(".")
        src.setdefault(top, {})[rest] = value
    for old, new in (rename or {}).items():
        if old in src:
            src[new] = src.pop(old)
    groups: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, value in params.items():
        top, _, rest = key.partition(".")
        groups.setdefault(top, {})[rest] = value
    out = dict(params)
    for top, group in groups.items():
        if include is not None and top not in include:
            continue
        if exclude is not None and top in exclude:
            continue
        if top in src:
            restored = _restore_like(group, src[top], f"params {top!r}")
            out.update({f"{top}.{rest}": v for rest, v in restored.items()})
    return out
