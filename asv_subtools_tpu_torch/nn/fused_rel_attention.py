"""Fused relative-position self-attention of the Conformer at inference:
the wrapper of kernel K5 and its plain version.

Replaces no Pallas kernel: the JAX package leaves this attention to XLA.
The CUDA source is csrc/rel_attention.cu; its header note gives the
design and the bound on an H100. The function takes the module's
projections as they lie, ``qkv`` [B, T, 3 D] (the fused q, k, v Dense)
and ``pos`` [T, D] (the position table's Dense), and returns the heads'
outputs [B, T, D] ahead of the output projection:
``softmax(((q+u) k^T + (q+v) p^T) / 8) v`` a head (Dh = 64), keys
masked where ``mask`` [B, T] is False, the rows of masked frames zero.
``RelPositionMultiHeadedAttention`` calls it on the card at inference
with a padding-only mask (nn/conformer/attention.py gives the rule).

On CPU tensors the wrapper runs the plain version; on CUDA tensors
(bf16 or fp16) it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ..kernels import _build

HEAD_DIM = 64  # the kernel's one head width
_SIGNATURES = {
    "asv_rel_attention_launch": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p], ctypes.c_int),
}


def fused_rel_attention_plain(qkv, pos, bias_u, bias_v, heads: int, mask=None):
    """Plain PyTorch version of the kernel, in at least float32: q+u and
    q+v rounded to the input type as the kernel forms them, the 2 Dh-deep
    scores, the masked softmax with P unnormalised and rounded to the
    input type before the product with v, the sum dividing at the end."""
    b, t, three_d = qkv.shape
    d = three_d // 3
    dh = d // heads
    ct = torch.promote_types(qkv.dtype, torch.float32)
    q, k, v = qkv.view(b, t, 3, heads, dh).unbind(2)  # [B, T, H, Dh]
    qu = (q + bias_u.to(q.dtype)).to(ct)
    qv = (q + bias_v.to(q.dtype)).to(ct)
    p = pos.view(t, heads, dh).to(ct)
    s = (torch.einsum("bqhd,bkhd->bhqk", qu, k.to(ct)) + torch.einsum("bqhd,khd->bhqk", qv, p)) / math.sqrt(dh)
    if mask is not None:
        s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    mx = s.amax(-1, keepdim=True)
    e = torch.exp(s - torch.where(torch.isfinite(mx), mx, 0.0))
    total = e.sum(-1, keepdim=True)
    out = torch.matmul(e.to(qkv.dtype).to(ct), v.transpose(1, 2).to(ct))  # [B, H, T, Dh]
    out = torch.where(total > 0, out / torch.where(total > 0, total, 1.0), 0.0)
    if mask is not None:
        out = out.masked_fill(~mask[:, None, :, None], 0.0)
    return out.transpose(1, 2).reshape(b, t, d).to(qkv.dtype)


def _launch_kernel(qkv, pos, bias_u, bias_v, heads, mask):
    b, t, three_d = qkv.shape
    d = three_d // 3
    if qkv.dtype not in (torch.bfloat16, torch.float16):
        raise ValueError(f"qkv must be bfloat16 or float16, got {qkv.dtype}")
    if d != heads * HEAD_DIM or three_d != 3 * d:
        raise ValueError(f"qkv [B, T, 3 D] with D = {heads} heads x {HEAD_DIM}, got {tuple(qkv.shape)}")
    if tuple(pos.shape) != (t, d) or tuple(bias_u.shape) != (heads, HEAD_DIM) \
            or tuple(bias_v.shape) != (heads, HEAD_DIM):
        raise ValueError("pos must be [T, D] and bias_u, bias_v [H, 64]")
    dev = qkv.device
    for name, a in (("pos", pos), ("bias_u", bias_u), ("bias_v", bias_v)):
        if a.dtype != qkv.dtype or a.device != dev:
            raise ValueError(f"{name} must have qkv's type and device")
    qkv, pos, bias_u, bias_v = (a.contiguous() for a in (qkv, pos, bias_u, bias_v))
    for name, a in (("qkv", qkv), ("pos", pos), ("bias_u", bias_u), ("bias_v", bias_v)):
        if a.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if mask is not None:
        if tuple(mask.shape) != (b, t):
            raise ValueError(f"mask must be [B, T] = {(b, t)}, got {tuple(mask.shape)}")
        mask = mask.to(device=dev, dtype=torch.bool).contiguous().view(torch.uint8)
    out = torch.empty((b, t, d), dtype=qkv.dtype, device=dev)
    lib = _build.load("rel_attention", _SIGNATURES)
    with torch.cuda.device(dev):
        code = lib.asv_rel_attention_launch(
            qkv.data_ptr(), pos.data_ptr(), bias_u.data_ptr(), bias_v.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            b, t, heads, int(qkv.dtype == torch.float16), torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, code, "relative-position attention kernel")
    fused_rel_attention.launches += 1
    return out


def fused_rel_attention(qkv: torch.Tensor, pos: torch.Tensor, bias_u: torch.Tensor, bias_v: torch.Tensor,
                        heads: int, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """qkv [B, T, 3 D], pos [T, D], bias_u and bias_v [H, Dh], mask [B, T]
    (True = valid) -> [B, T, D] in qkv's type. ``fused_rel_attention.launches``
    counts kernel launches (one per call)."""
    if qkv.dim() != 3:
        raise ValueError(f"qkv must be [B, T, 3 D], got shape {tuple(qkv.shape)}")
    if qkv.device.type == "cpu":
        return fused_rel_attention_plain(qkv, pos, bias_u, bias_v, heads, mask)
    if qkv.device.type != "cuda":
        raise ValueError(f"fused_rel_attention runs on cpu or cuda tensors, got {qkv.device}")
    if torch.compiler.is_compiling():  # traced (torch.export): one node of the graph
        return fused_rel_attention_op(qkv, pos, bias_u, bias_v, heads, mask)
    return _launch_kernel(qkv, pos, bias_u, bias_v, heads, mask)


fused_rel_attention.launches = 0


# The kernel as a custom op, so that torch.export keeps it as one node of an
# exported program (the ctypes launch reads data pointers, which a tracer's
# fake tensors do not have); it runs on CUDA tensors only, where the
# module takes the kernel. Eager calls launch directly: a custom op's
# first dispatch imports torch._dynamo and sympy (9-12 s on an H100 host
# with torch 2.11), which the extraction's set-up would pay.
@torch.library.custom_op("asv_subtools_tpu_torch::fused_rel_attention", mutates_args=(), device_types="cuda")
def fused_rel_attention_op(qkv: torch.Tensor, pos: torch.Tensor, bias_u: torch.Tensor, bias_v: torch.Tensor,
                           heads: int, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _launch_kernel(qkv, pos, bias_u, bias_v, heads, mask)


@fused_rel_attention_op.register_fake
def _(qkv, pos, bias_u, bias_v, heads, mask=None):
    return qkv.new_empty((qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3))
