"""Fused ECAPA Res2Net chain at inference: the wrapper of kernel K3 and its
plain version.

Replaces asv_subtools_tpu/nn/pallas_res2.py `fused_res2_chain` (the Pallas
kernel at :80/:113). The CUDA source is csrc/res2_chain.cu; its header
note gives the design and the bound on an H100.

x [B, T, C] with C = (n_stages + 1) * h. Group 0 passes through; stage i
computes ``sp = part[i+1] (+ sp)``, a k=3 dilated conv with zero "same"
padding as ``[T, 3h] @ [3h, h]``, bias, relu and the folded BN affine.
Rounding follows the JAX kernel: the chain state is f32 between stages,
the product's operands are rounded to x's type (bf16 in serving, so a
product of two operands is exact in f32) and summed in f32, outputs are
in x's type. With f32 x everything stays f32. Unlike the TPU kernel, h
need not be a multiple of 128 and T has no limit. On the card bf16 x with
h in {16, 32, 64, 128} runs on the tensor cores (where its shared memory
fits: at h = 128 up to dilation 14); f32 x and other widths up to 128 run
on the CUDA cores. The launcher chooses and plans (csrc/launch_plan.h).

On CPU tensors the wrapper runs the plain version; on CUDA tensors it
launches the kernel (through its custom op while torch.export traces) or
raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..kernels import _build

_SIGNATURES = {
    "asv_res2_chain_workspace_bytes": ([ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_longlong)], ctypes.c_int),
    "asv_res2_chain_launch": ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int),
                                                                            ctypes.c_void_p], ctypes.c_int),
}


def _check_geometry(x, w, b, bn_scale, bn_shift, dilation):
    if x.dim() != 3:
        raise ValueError(f"x must be [B, T, C], got shape {tuple(x.shape)}")
    if w.dim() != 4:
        raise ValueError(f"w must be [n_stages, 3, h, h], got shape {tuple(w.shape)}")
    n, k, h, h2 = w.shape
    if k != 3 or h != h2 or (n + 1) * h != x.shape[-1]:
        raise ValueError(f"unsupported res2 geometry: x {tuple(x.shape)}, w {tuple(w.shape)}")
    for name, v in (("b", b), ("bn_scale", bn_scale), ("bn_shift", bn_shift)):
        if tuple(v.shape) != (n, h):
            raise ValueError(f"{name} must be [{n}, {h}], got {tuple(v.shape)}")
    if dilation < 1:
        raise ValueError(f"dilation must be >= 1, got {dilation}")
    return n, h


def fused_res2_chain_plain(x, w, b, bn_scale, bn_shift, dilation: int = 1):
    """Plain PyTorch version of the kernel, with its rounding."""
    n, h = _check_geometry(x, w, b, bn_scale, bn_shift, dilation)
    f32, d, t = torch.float32, dilation, x.shape[1]
    parts = torch.split(x, h, dim=-1)
    outs = [parts[0]]
    sp = None
    for i in range(n):
        part = parts[i + 1].to(f32)
        sp = part if i == 0 else sp + part
        op = F.pad(sp.to(x.dtype).to(f32), (0, 0, d, d))  # zero "same" padding over T
        taps = torch.cat([op[:, k * d:k * d + t] for k in range(3)], dim=-1)  # [B, T, 3h]
        z = taps @ w[i].reshape(3 * h, h).to(x.dtype).to(f32)
        sp = torch.relu(z + b[i].to(f32)) * bn_scale[i].to(f32) + bn_shift[i].to(f32)
        outs.append(sp.to(x.dtype))
    return torch.cat(outs, dim=-1)


def _launch_kernel(x, w, b, bn_scale, bn_shift, dilation):
    n, h = _check_geometry(x, w, b, bn_scale, bn_shift, dilation)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if w.dtype != x.dtype:
        raise ValueError(f"w must have x's type {x.dtype}, got {w.dtype}")
    dev = x.device
    # [B, C, T] time-contiguous: free when x is a transposed view of the
    # model's [B, C, T] activations
    xt = x.transpose(1, 2).contiguous()
    out = torch.empty_like(xt)
    args = [xt, w.contiguous(), *(v.to(device=dev, dtype=torch.float32).contiguous() for v in (b, bn_scale, bn_shift)),
            out]
    route = _build.planned_launch(_build.load("res2_chain", _SIGNATURES), "asv_res2_chain", dev,
                                  tuple(a.data_ptr() for a in args),
                                  (x.shape[0], x.shape[1], h, n, dilation, int(x.dtype == torch.bfloat16)),
                                  "res2 chain kernel")
    fused_res2_chain.launches += 1
    fused_res2_chain.last_route = "tensor_core" if route else "cuda_core"
    return out.transpose(1, 2)


def fused_res2_chain(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    bn_scale: torch.Tensor,
    bn_shift: torch.Tensor,
    dilation: int = 1,
) -> torch.Tensor:
    """x [B, T, C] -> [B, T, C] in x's type.

    w [n_stages, 3, h, h]: the conv taps as ``[stage, tap, in, out]``, in
    x's type; b [n_stages, h]: the conv bias; bn_scale/bn_shift
    [n_stages, h]: each stage's BN folded from its running statistics.
    The kernel works on ``[B, C, T]`` memory: an x that is a transposed
    view of such memory (as the port's model hands it over) is taken as it
    is, and the result is a ``[B, T, C]`` view of the same layout.
    ``fused_res2_chain.launches`` counts kernel launches (one per call);
    ``fused_res2_chain.last_route`` names the kernel the last launch ran,
    "tensor_core" or "cuda_core" (see the module's note).
    """
    if x.device.type == "cpu":
        return fused_res2_chain_plain(x, w, b, bn_scale, bn_shift, dilation)
    if x.device.type != "cuda":
        raise ValueError(f"fused_res2_chain runs on cpu or cuda tensors, got {x.device}")
    if torch.compiler.is_compiling():  # traced (torch.export): one node of the graph
        return fused_res2_chain_op(x, w, b, bn_scale, bn_shift, dilation)
    return _launch_kernel(x, w, b, bn_scale, bn_shift, dilation)


# The kernel as a custom op, so that torch.export keeps it as one node of
# an exported program (the ctypes launch reads data pointers, which a
# tracer's fake tensors do not have): its CUDA implementation launches the
# kernel, its CPU implementation is the plain version. Eager calls launch
# directly: a custom op's first dispatch imports torch._dynamo and sympy.
@torch.library.custom_op("asv_subtools_tpu_torch::fused_res2_chain", mutates_args=(), device_types="cuda")
def fused_res2_chain_op(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, bn_scale: torch.Tensor,
                        bn_shift: torch.Tensor, dilation: int) -> torch.Tensor:
    return _launch_kernel(x, w, b, bn_scale, bn_shift, dilation)


@fused_res2_chain_op.register_kernel("cpu")
def _(x, w, b, bn_scale, bn_shift, dilation):
    return fused_res2_chain_plain(x, w, b, bn_scale, bn_shift, dilation)


@fused_res2_chain_op.register_fake
def _(x, w, b, bn_scale, bn_shift, dilation):
    if x.device.type != "cuda":
        return torch.empty_like(x, memory_format=torch.contiguous_format)
    bsz, t, c = x.shape
    return x.new_empty((bsz, c, t)).transpose(1, 2)  # the kernel's: a [B, T, C] view of [B, C, T] memory


fused_res2_chain.launches = 0
fused_res2_chain.last_route = None
