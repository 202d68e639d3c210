"""Model export for serving (counterpart: asv_subtools_tpu/export.py:26-57,
257-295; parity: pipeline/export_jit_model.sh + onestep/export_jit.py:26-58
and the nnet.config blueprint idiom, utils.py:189-202).

Two artifacts, as the reference's jit ``.pt`` and ``nnet.config``:

  <dir>/model_b{B}_t{T}.pt2  — a ``torch.export`` program of the embed
                               function for one (batch, bucket) shape,
                               loadable without the model's Python class;
  <dir>/nnet_config.yaml     — model name + constructor params + checkpoint,
                               so Python consumers can rebuild the module.

An exported program holds the card's kernels K2, K3 and K4 as custom ops
(``asv_subtools_tpu_torch::fused_*``, nn/fused_*.py); a process that loads
one must have the ops registered first: importing this module (or
``asv_subtools_tpu_torch.nn``) registers them, as ``load_embed_fn`` does.
A program is exported for one device and runs there. JAX's
``export_pjrt_bundle`` and ``export_pjrt_embed_bundles`` (bundles for the
native PJRT runner) wait for the CUDA-side executor (ROADMAP Queue 1,
item 10b).
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional, Sequence

import torch
from torch import nn

from . import nn as _kernels  # noqa: F401  (registers the kernels' custom ops for torch.export.load)
from .device import resolve_device
from .utils import load_yaml, save_yaml


class _EmbedModule(nn.Module):
    """A module around an embed function, for torch.export (tensors the
    function closes over become the program's constants)."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return self.fn(x, mask)


def export_embed_fn(
    embed_fn: Callable,
    feat_dim: int,
    out_dir: str,
    bucket_lengths: Sequence[int] = (200, 400, 800, 1600, 3200, 6400, 10000),
    batch_sizes: Sequence[int] = (1, 8, 32),
    device: Any = None,
) -> Dict[str, str]:
    """Export ``embed_fn(x [B, T, D] f32, mask [B, T] bool) -> [B, E]`` (a
    module or a function) for every (bucket, batch) shape on ``device``
    (the CUDA card unless ``device="cpu"``); returns {shape key: path}."""
    dev = resolve_device(device)
    module = embed_fn if isinstance(embed_fn, nn.Module) else _EmbedModule(embed_fn)
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for t in bucket_lengths:
        for b in batch_sizes:
            example = (torch.zeros((b, t, feat_dim), dtype=torch.float32, device=dev),
                       torch.ones((b, t), dtype=torch.bool, device=dev))
            with torch.no_grad():
                program = torch.export.export(module, example)
            key = f"b{b}_t{t}"
            path = os.path.join(out_dir, f"model_{key}.pt2")
            torch.export.save(program, path)
            paths[key] = path
    return paths


def load_embed_fn(path: str, device: Any = None) -> Callable:
    """Load an exported embed function; returns ``fn(x, mask) -> [B, E]``
    running on ``device`` (the CUDA card unless ``device="cpu"``), which
    must be the device the program was exported for. The kernels' custom
    ops are registered by this module's import."""
    dev = resolve_device(device)
    program = torch.export.load(path)
    module = program.module()
    held = {t.device.type for t in list(program.state_dict.values()) + list(program.constants.values())
            if isinstance(t, torch.Tensor)}
    if held - {dev.type}:
        raise ValueError(f"{path} holds tensors on {sorted(held)}; it cannot run on {dev}")

    def fn(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return module(x.to(dev), mask.to(dev))

    return fn


def write_nnet_config(out_dir: str, model_name: str, model_params: Dict, checkpoint_path: str,
                      feat_config: Optional[Dict] = None) -> str:
    """Blueprint + creation-string equivalent: enough to rebuild the model
    and reload its weights (the reference's config/nnet.config), with the
    keys of JAX's ``nnet_config.yaml``."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "nnet_config.yaml")
    save_yaml({"model_name": model_name, "model_params": model_params,
               "checkpoint": os.path.abspath(checkpoint_path), "feat_config": feat_config or {}}, path)
    return path


def load_model_from_config(config_path: str, device: Any = None):
    """Rebuild ``(module, variables, cfg)`` from nnet_config.yaml: the
    module from the port's ``MODELS`` on ``device`` (the CUDA card unless
    ``device="cpu"``), ``variables = {"params", "batch_stats"}`` from the
    checkpoint (train/checkpoint.py: state_dict names, ``backbone.*`` for
    the module's), as JAX's returns its trees. A port checkpoint and a JAX
    checkpoint are different files: this reads the port's."""
    from .models import MODELS
    from .train.checkpoint import load_checkpoint

    cfg = load_yaml(config_path)
    module = MODELS[cfg["model_name"]](**cfg.get("model_params", {}), device=device)
    payload = load_checkpoint(cfg["checkpoint"], device=device)
    variables = {"params": payload["params"], "batch_stats": payload.get("batch_stats", {})}
    return module, variables, cfg
