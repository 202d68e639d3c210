"""Fused masked statistics pooling: the wrapper of kernel K4 and its plain
version.

Replaces asv_subtools_tpu/nn/pallas_pooling.py `fused_stats_pooling` (the
Pallas kernel at :52/:70). The CUDA source is csrc/stats_pooling.cu; its
header note gives the design and the bound on an H100.

x [B, T, D], mask [B, T] (True = valid) -> [B, 2D] float32: the mean over
valid frames followed by the biased std ``sqrt(max(E[x^2] - mean^2, eps))``
with ``count = max(sum(mask), 1)``, from one pass over x. The sums are
taken of ``x - shift`` (per row and feature), where shift is the row's
first valid frame standing in for the mean, so the one-pass variance does
not cancel when ``|mean| >> std``. Any shift gives the same function; a
masked frame may hold anything (inf included) and is never read into a
sum or a shift; a row with no valid frame gives mean 0 and std
``sqrt(eps)``, as the JAX kernel does.

x is read once in its own type (float32 or bfloat16); the sums and the
result are float32, as the JAX kernel returns them (the module casts to
x's type). On CPU tensors the wrapper runs the plain version; on CUDA
tensors it launches the kernel (through its custom op while torch.export
traces) or raises.

Two kernels share the source. x aligned to 16 bytes (the served shapes)
goes through the ring kernel: persistent blocks, rows copied to shared
memory by ``cp.async.bulk``. Anything else goes through the direct kernel
with scalar loads. Both cut T into spans when (row, D tile) pairs alone
are too few to fill the card; a second small kernel merges the spans. The
launcher chooses and plans (csrc/launch_plan.h).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..kernels import _build

_EPS = 1.0e-10
_ROUTES = {None: -1, "direct": 0, "ring": 1}  # the launcher's route argument (csrc/launch_plan.h stats_plan)
_SIGNATURES = {
    "asv_stats_pool_workspace_bytes": ([ctypes.c_void_p] + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 5
                                       + [ctypes.POINTER(ctypes.c_longlong)], ctypes.c_int),
    "asv_stats_pool_launch": ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 5
                              + [ctypes.c_float, ctypes.POINTER(ctypes.c_int), ctypes.c_void_p], ctypes.c_int),
}


def fused_stats_pooling_plain(x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                              eps: float = _EPS) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same shifted sums in f32."""
    xf = x.to(torch.float32)
    valid = (torch.ones(x.shape[:2], dtype=torch.bool, device=x.device) if mask is None
             else mask.to(torch.bool))
    raw = valid.sum(1, keepdim=True).to(torch.float32)  # [B, 1]
    cnt = torch.clamp_min(raw, 1.0)
    first = valid.to(torch.int32).argmax(1)  # the first valid frame (0 where there is none)
    shift = torch.where(raw > 0, xf[torch.arange(x.shape[0], device=x.device), first], 0.0)
    delta = torch.where(valid[..., None], xf - shift[:, None, :], 0.0)
    mu = delta.sum(1) / cnt
    var = (delta * delta).sum(1) / cnt - mu * mu
    return torch.cat([shift + mu, torch.sqrt(torch.clamp_min(var, eps))], dim=-1)


def _mask_bytes(mask: Optional[torch.Tensor], device: torch.device) -> Optional[torch.Tensor]:
    """The mask as the kernels read it: one byte a frame, contiguous, on
    ``device``. A contiguous bool (or uint8) mask already there is
    reinterpreted, not copied; anything else is converted (non-zero = valid)."""
    if mask is None:
        return None
    if mask.device == device and mask.is_contiguous():
        if mask.dtype == torch.bool:
            return mask.view(torch.uint8)
        if mask.dtype == torch.uint8:
            return mask
    return mask.to(device=device, dtype=torch.bool).contiguous().view(torch.uint8)


def _launch_kernel(x: torch.Tensor, mask: Optional[torch.Tensor], eps: float,
                   route: Optional[str] = None) -> torch.Tensor:
    """Launch on a CUDA tensor. ``route``: "ring" or "direct"; None lets the
    launcher take the ring kernel whenever x is aligned for it."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    b, t, d = x.shape
    dev = x.device
    if x.stride(2) != 1:
        x = x.contiguous()
    m = _mask_bytes(mask, dev)
    out = torch.empty((b, 2 * d), dtype=torch.float32, device=dev)
    # a route that does not take x (the ring kernel's 16-byte loads need D,
    # the strides and the address aligned) has no plan
    facts = (x.data_ptr(), x.stride(0), x.stride(1), b, t, d, int(x.dtype == torch.bfloat16), _ROUTES[route])
    taken = _build.planned_launch(_build.load("stats_pooling", _SIGNATURES), "asv_stats_pool", dev,
                                  (None if m is None else m.data_ptr(), out.data_ptr()), facts,
                                  "statistics pooling kernel", (float(eps),))
    fused_stats_pooling.launches += 1
    fused_stats_pooling.last_route = "ring" if taken else "direct"
    return out


def fused_stats_pooling(x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                        eps: float = _EPS) -> torch.Tensor:
    """x [B, T, D] (any batch and time strides, D contiguous or copied),
    mask [B, T] True = valid -> [B, 2D] float32 (mean ++ biased std).
    ``fused_stats_pooling.launches`` counts kernel launches (one per call;
    the call runs one CUDA kernel, or two when T is cut into spans), and
    ``fused_stats_pooling.last_route`` names the kernel of the last launch
    ("ring" or "direct")."""
    if x.dim() != 3 or x.shape[1] == 0:
        raise ValueError(f"x must be [B, T, D] with T > 0, got shape {tuple(x.shape)}")
    if mask is not None and tuple(mask.shape) != tuple(x.shape[:2]):
        raise ValueError(f"mask must be [B, T] = {tuple(x.shape[:2])}, got {tuple(mask.shape)}")
    if x.device.type == "cpu":
        return fused_stats_pooling_plain(x, mask, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_stats_pooling runs on cpu or cuda tensors, got {x.device}")
    if torch.compiler.is_compiling():  # traced (torch.export): one node of the graph
        return fused_stats_pooling_op(x, mask, eps)
    return _launch_kernel(x, mask, eps)


fused_stats_pooling.launches = 0
fused_stats_pooling.last_route = None


# The kernel as a custom op, so that torch.export keeps it as one node of
# an exported program (the ctypes launch reads data pointers, which a
# tracer's fake tensors do not have): its CUDA implementation launches the
# kernel, its CPU implementation is the plain version. Eager calls launch
# directly: a custom op's first dispatch imports torch._dynamo and sympy.
@torch.library.custom_op("asv_subtools_tpu_torch::fused_stats_pooling", mutates_args=(), device_types="cuda")
def fused_stats_pooling_op(x: torch.Tensor, mask: Optional[torch.Tensor] = None, eps: float = _EPS) -> torch.Tensor:
    return _launch_kernel(x, mask, eps)


@fused_stats_pooling_op.register_kernel("cpu")
def _(x, mask=None, eps=_EPS):
    return fused_stats_pooling_plain(x, mask, eps)


@fused_stats_pooling_op.register_fake
def _(x, mask=None, eps=_EPS):
    return x.new_empty((x.shape[0], 2 * x.shape[2]), dtype=torch.float32)
