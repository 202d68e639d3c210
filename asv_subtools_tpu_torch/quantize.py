"""Weight-only int8 quantization of a state_dict for storage (counterpart:
asv_subtools_tpu/quantize.py:23-85; parity: the reference's optional
dynamic int8 quantization at jit export, pipeline/onestep/export_jit.py).

Every float leaf with at least two dims and ``min_size`` elements becomes
``{"int8_values": int8, "int8_scales": float32}``: symmetric per output
channel, ``scale = max(max|w| / 127, 1e-12)``, ``q = clip(round(w /
scale), +-127)``. The output channel is JAX's last axis of the flax leaf,
which is another axis of the port's leaf: dim 0 of a conv or Dense weight
(the rules of weights.py transpose it there), the last dim of a leaf that
keeps JAX's layout (``_SplitGlobalConv``'s ``kernel [1, 3C, K]``, the
attention's ``pos_bias_u/v [H, Dh]``, the loss heads' ``weight``), as
``weights.output_axis`` says. The scale keeps its dims (size 1 but on that
axis). Biases, norm leaves and small leaves stay as they are.
``dequantize_params`` gives back a state_dict in float32 (or ``dtype``).
The quantization runs in numpy on the host, as JAX's does.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .weights import output_axis

_KEYS = {"int8_values", "int8_scales"}


def _quantize_leaf(w: np.ndarray, axis: int) -> Dict[str, torch.Tensor]:
    axis = axis % w.ndim
    axes = tuple(a for a in range(w.ndim) if a != axis)
    scale = np.max(np.abs(w), axis=axes, keepdims=True) / 127.0
    scale = np.maximum(scale, 1e-12)
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return {"int8_values": torch.from_numpy(q), "int8_scales": torch.from_numpy(scale.astype(np.float32))}


def quantize_params(state_dict: Mapping[str, torch.Tensor], min_size: int = 1024) -> Dict[str, Any]:
    """Quantize every float leaf with >= 2 dims and >= ``min_size``
    elements; the others stay (as CPU tensors)."""
    out: Dict[str, Any] = {}
    for key, value in state_dict.items():
        arr = value.detach().cpu().numpy()
        if arr.ndim >= 2 and arr.size >= min_size and np.issubdtype(arr.dtype, np.floating):
            out[key] = _quantize_leaf(arr.astype(np.float32), output_axis(key, value))
        else:
            out[key] = value.detach().cpu()
    return out


def _is_qleaf(node: Any) -> bool:
    return isinstance(node, Mapping) and set(node.keys()) == _KEYS


def dequantize_params(qstate: Mapping[str, Any], dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`quantize_params`: a state_dict."""
    return {k: (v["int8_values"].to(torch.float32) * v["int8_scales"]).to(dtype) if _is_qleaf(v) else v
            for k, v in qstate.items()}


def quantization_error(state_dict: Mapping[str, torch.Tensor], qstate: Mapping[str, Any]) -> float:
    """Max over leaves of max|w - deq(q(w))| / max|w| (float32)."""
    deq = dequantize_params(qstate)
    errs = []
    for key, value in state_dict.items():
        a = value.detach().cpu().to(torch.float32)
        b = deq[key].to(torch.float32)
        denom = max(float(a.abs().max()) if a.numel() else 0.0, 1e-12)
        errs.append(float((a - b).abs().max()) / denom if a.numel() else 0.0)
    return max(errs) if errs else 0.0

