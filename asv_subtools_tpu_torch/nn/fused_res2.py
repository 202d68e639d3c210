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
on the CUDA cores.

On CPU tensors the wrapper runs the plain version; on CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..kernels import _build

_ROWS = 192    # frames one block computes per stage in csrc/res2_chain.cu
_KC = 32       # weight rows per shared-memory chunk of the CUDA-core kernel
_MAX_H = 128   # a thread's output channels stay in registers up to here
_TENSOR_H = (16, 32, 64, 128)  # widths of the bf16 tensor-core kernel
_SLOTS = 2     # weight ring slots of the tensor-core kernel
_SIGNATURES = {
    "asv_res2_chain_launch": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 13 + [ctypes.c_void_p],
                              ctypes.c_int),
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


def tile_plan(t: int, n_stages: int, dilation: int):
    """(frames per tile, tiles, row stride of the CUDA-core kernel's
    shared-memory state).

    A tile of TT output frames starts from input frames
    [t0 - n*d, t0 + TT + n*d) and recomputes the halo; stage 0 computes
    TT + 2*(n-1)*d frames, which must fit the block's 192 rows. TT is even,
    so that every tile starts on an even frame (4-byte pairs of bf16)."""
    max_tt = _ROWS - 2 * (n_stages - 1) * dilation  # even
    if max_tt < 16:
        raise ValueError(f"dilation {dilation} with {n_stages} stages leaves no room for a tile "
                         f"in the kernel's {_ROWS} rows")
    tiles = -(-t // max_tt)
    tt = -(-t // tiles)
    tt += tt % 2
    rp = ((n_stages + 1) * dilation + _ROWS) | 1  # odd: conflict-free column writes
    return tt, tiles, rp


def tensor_core_plan(t: int, h: int, n_stages: int, dilation: int):
    """(TT, tiles, state rows, part row stride SP, shared-memory bytes) of
    the tensor-core kernel (csrc/res2_chain.cu `mma_layout`).

    The part buffer holds a channel's frames [ta, ta + SP) from an even ta:
    the window of TT + 2*n*d frames and one more for the even start, and one
    spare; SP = 8 (mod 64) puts the fragments' 2-byte accesses on 32 banks."""
    tt, tiles, _ = tile_plan(t, n_stages, dilation)
    rows = (n_stages + 1) * dilation + _ROWS
    need = tt + 2 * n_stages * dilation + 2
    sp = need + (8 - need) % 64
    ring = -(-2 * rows * (h + 8) // 128) * 128
    part = ring + _SLOTS * 2 * h * (h + 8)
    bars = -(-(part + 2 * h * sp) // 8) * 8
    return tt, tiles, rows, sp, bars + 8 * 2 * _SLOTS


def _launch_kernel(x, w, b, bn_scale, bn_shift, dilation):
    n, h = _check_geometry(x, w, b, bn_scale, bn_shift, dilation)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if w.dtype != x.dtype:
        raise ValueError(f"w must have x's type {x.dtype}, got {w.dtype}")
    if h > _MAX_H:
        raise ValueError(f"hidden width {h} above the kernel's limit {_MAX_H}")
    bsz, t, c = x.shape
    if bsz > 65535:
        raise ValueError(f"batch {bsz} above the kernel's limit 65535")
    tensor = x.dtype == torch.bfloat16 and h in _TENSOR_H
    if tensor:
        tt, tiles, rp, sp, smem = tensor_core_plan(t, h, n, dilation)
        tensor = smem <= _build.SMEM_LIMIT
    if tensor:
        # [n, 3, h out, h in + 8]: each tap's weights one bulk copy, rows
        # padded by 16 bytes
        wc = F.pad(w.permute(0, 1, 3, 2), (0, 8)).contiguous()
    else:  # the CUDA-core kernel: the f32 state [h][rp] and a chunk of weights
        tt, tiles, rp = tile_plan(t, n, dilation)
        sp, smem = 0, 4 * (h * rp + _KC * h)
        wc = w.contiguous()
    if smem > _build.SMEM_LIMIT:
        raise ValueError(f"hidden width {h} at dilation {dilation} needs {smem} bytes of shared memory")
    dev = x.device
    # [B, C, T] time-contiguous: free when x is a transposed view of the
    # model's [B, C, T] activations
    xt = x.transpose(1, 2).contiguous()
    out = torch.empty_like(xt)
    even = t % 2 == 0 and xt.data_ptr() % 4 == 0  # the parts come as 4-byte pairs of frames
    vecs = [v.to(device=dev, dtype=torch.float32).contiguous() for v in (b, bn_scale, bn_shift)]
    lib = _build.load("res2_chain", _SIGNATURES)
    with torch.cuda.device(dev):
        code = lib.asv_res2_chain_launch(
            xt.data_ptr(), wc.data_ptr(), vecs[0].data_ptr(), vecs[1].data_ptr(), vecs[2].data_ptr(),
            out.data_ptr(), bsz, t, h, n, dilation, tt, tiles, rp, sp, smem,
            int(x.dtype == torch.bfloat16), int(tensor), int(even), torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, code, "res2 chain kernel")
    fused_res2_chain.launches += 1
    fused_res2_chain.last_route = "tensor_core" if tensor else "cuda_core"
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
    return _launch_kernel(x, w, b, bn_scale, bn_shift, dilation)


fused_res2_chain.launches = 0
fused_res2_chain.last_route = None
