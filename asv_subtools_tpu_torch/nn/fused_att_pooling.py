"""Fused ECAPA attentive statistics pooling: the wrapper of kernel K2 and
its plain version.

Replaces asv_subtools_tpu/nn/pallas_att_pooling.py
`fused_attentive_stats_pool` (the Pallas kernel at :132/:177). The CUDA
source is csrc/att_pooling.cu; its header note gives the design and the
bound on an H100.

The softmax over time subtracts a true per-channel max, the semantics of
the XLA path (asv_subtools_tpu/models/ecapa.py:273-279); the TPU kernel
clamps the logits at 80 instead, which agrees wherever they stay below 80.

On the card bf16 x runs the products on the tensor cores
("tensor_core"), f32 x on the CUDA cores in true f32 ("cuda_core");
``fused_attentive_stats_pool.last_route`` names the route of the last
launch; the launcher chooses and plans (csrc/launch_plan.h). On CPU
tensors the wrapper runs the plain version; on CUDA tensors it launches
the kernel (through its custom op while torch.export traces) or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..kernels import _build

_SIGNATURES = {
    "asv_att_pool_workspace_bytes": ([ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong)], ctypes.c_int),
    "asv_att_pool_launch": ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int),
                                                                            ctypes.c_void_p], ctypes.c_int),
}


def fused_attentive_stats_pool_plain(x, wx, wm, ws, b1, bn_scale, bn_shift, w2, b2, mask=None):
    """Plain PyTorch version of the kernel: the same sums in f32, with the
    products of x and the weights taken on their own types' values."""
    f32 = torch.float32
    xf = x.to(f32)
    m = (torch.ones(x.shape[:2], dtype=f32, device=x.device) if mask is None
         else mask.to(f32))[..., None]
    cnt = torch.clamp_min(m.sum(1), 1.0)  # [B, 1]
    xm = xf * m
    mean = xm.sum(1) / cnt
    var = ((xm * xf).sum(1) - cnt * mean * mean) / torch.clamp_min(cnt - 1.0, 1.0)
    std = torch.sqrt(torch.clamp_min(var, 0.0) + 1e-5)
    glob = mean @ wm.to(f32) + std @ ws.to(f32) + b1.to(f32)  # [B, K]
    u = xf @ wx.to(f32) + glob[:, None, :]
    h = torch.tanh(torch.relu(u) * bn_scale.to(f32) + bn_shift.to(f32))
    a = h.to(w2.dtype).to(f32) @ w2.to(f32) + b2.to(f32)  # [B, T, C]
    a = a.masked_fill(m == 0, float("-inf"))
    mx = a.amax(1, keepdim=True)
    e = torch.where(m != 0, torch.exp(a - torch.where(torch.isfinite(mx), mx, 0.0)), 0.0)
    s = torch.clamp_min(e.sum(1), 1e-30)
    ex = e * xf
    mean_w = ex.sum(1) / s
    var_w = (ex * xf).sum(1) / s - mean_w * mean_w
    return torch.cat([mean_w, torch.sqrt(torch.clamp_min(var_w, 1e-5))], dim=-1)


def _launch_kernel(x, wx, wm, ws, b1, bn_scale, bn_shift, w2, b2, mask):
    b, t, c = x.shape
    k = wx.shape[1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name, w in (("wx", wx), ("wm", wm), ("ws", ws), ("w2", w2)):
        if w.dtype != x.dtype:
            raise ValueError(f"{name} must have x's type {x.dtype}, got {w.dtype}")
    if tuple(wx.shape) != (c, k) or tuple(wm.shape) != (c, k) or tuple(ws.shape) != (c, k) \
            or tuple(w2.shape) != (k, c):
        raise ValueError("weights must be wx, wm, ws [C, K] and w2 [K, C]")
    dev = x.device
    # [B, C, T] time-contiguous: free when x is a transposed view of the
    # model's [B, C, T] activations
    xt = x.transpose(1, 2).contiguous()
    if mask is None:
        m = None
    elif mask.dtype == torch.bool:  # one byte a frame already: no conversion
        m = mask.to(device=dev).contiguous().view(torch.uint8)
    else:
        m = mask.to(device=dev, dtype=torch.uint8).contiguous()
    f32 = [v.to(device=dev, dtype=torch.float32).contiguous() for v in (b1, bn_scale, bn_shift, b2)]
    out = torch.empty((b, 2 * c), dtype=torch.float32, device=dev)
    args = [wx.contiguous(), wm.contiguous(), ws.contiguous(), *f32[:3], w2.contiguous(), f32[3], out]
    route = _build.planned_launch(_build.load("att_pooling", _SIGNATURES), "asv_att_pool", dev,
                                  (xt.data_ptr(), None if m is None else m.data_ptr(), *(a.data_ptr() for a in args)),
                                  (b, c, t, k, int(x.dtype == torch.bfloat16)), "attentive pooling kernel")
    fused_attentive_stats_pool.launches += 1
    fused_attentive_stats_pool.last_route = "tensor_core" if route else "cuda_core"
    return out


def fused_attentive_stats_pool(
    x: torch.Tensor,
    wx: torch.Tensor,
    wm: torch.Tensor,
    ws: torch.Tensor,
    b1: torch.Tensor,
    bn_scale: torch.Tensor,
    bn_shift: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """x [B, T, C] -> [B, 2C] attentive (mean ++ std) in float32, as the
    JAX kernel returns it (the module casts to x's type).

    wx/wm/ws [C, K] + b1 [K]: the att1 1x1 conv over [x; mean; std] split
    blockwise; bn_scale/bn_shift [K]: the attention BN folded from its
    running statistics; w2 [K, C] + b2 [C]: att2. mask [B, T], True =
    valid. ``fused_attentive_stats_pool.launches`` counts kernel launches
    (one per call; the call runs four CUDA kernels);
    ``fused_attentive_stats_pool.last_route`` names the attend kernel the
    last launch ran, "tensor_core" or "cuda_core" (see the module's note).
    """
    if x.dim() != 3:
        raise ValueError(f"x must be [B, T, C], got shape {tuple(x.shape)}")
    if x.device.type == "cpu":
        return fused_attentive_stats_pool_plain(x, wx, wm, ws, b1, bn_scale, bn_shift, w2, b2, mask)
    if x.device.type != "cuda":
        raise ValueError(f"fused_attentive_stats_pool runs on cpu or cuda tensors, got {x.device}")
    if torch.compiler.is_compiling():  # traced (torch.export): one node of the graph
        return fused_attentive_stats_pool_op(x, wx, wm, ws, b1, bn_scale, bn_shift, w2, b2, mask)
    return _launch_kernel(x, wx, wm, ws, b1, bn_scale, bn_shift, w2, b2, mask)


fused_attentive_stats_pool.launches = 0
fused_attentive_stats_pool.last_route = None


# The kernel as a custom op, so that torch.export keeps it as one node of
# an exported program (the ctypes launch reads data pointers, which a
# tracer's fake tensors do not have): its CUDA implementation launches the
# kernel, its CPU implementation is the plain version. Eager calls launch
# directly: a custom op's first dispatch imports torch._dynamo and sympy.
@torch.library.custom_op("asv_subtools_tpu_torch::fused_attentive_stats_pool", mutates_args=(),
                         device_types="cuda")
def fused_attentive_stats_pool_op(x: torch.Tensor, wx: torch.Tensor, wm: torch.Tensor, ws: torch.Tensor,
                                  b1: torch.Tensor, bn_scale: torch.Tensor, bn_shift: torch.Tensor,
                                  w2: torch.Tensor, b2: torch.Tensor,
                                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _launch_kernel(x, wx, wm, ws, b1, bn_scale, bn_shift, w2, b2, mask)


@fused_attentive_stats_pool_op.register_kernel("cpu")
def _(x, wx, wm, ws, b1, bn_scale, bn_shift, w2, b2, mask=None):
    return fused_attentive_stats_pool_plain(x, wx, wm, ws, b1, bn_scale, bn_shift, w2, b2, mask)


@fused_attentive_stats_pool_op.register_fake
def _(x, wx, wm, ws, b1, bn_scale, bn_shift, w2, b2, mask=None):
    return x.new_empty((x.shape[0], 2 * x.shape[2]), dtype=torch.float32)
