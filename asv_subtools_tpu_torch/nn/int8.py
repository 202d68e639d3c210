"""Dynamic int8 products for serving (counterpart:
asv_subtools_tpu/nn/int8.py:28-49).

The scheme of JAX's ``dynamic_int8_dot``, quantized on the fly from the
live weights (the state_dict is unchanged):

* activations: symmetric int8 per row (each frame), scale
  ``max(max|x| over channels, 1e-8) / 127``;
* weights: symmetric int8 per output channel, scale
  ``max(max|w| over inputs, 1e-12) / 127``;
* ``round`` (half to even, as ``jnp.round``) then ``clip`` to +-127; the
  product in int32; the rescale and the bias in float32.

On the card the product is ``torch._int_mm`` (s8 x s8 -> s32 through
cuBLASLt): JAX runs this product in XLA, not in a Pallas kernel, so a
library GEMM is its counterpart. ``_int_mm`` takes m > 16 rows and k, n
multiples of 8; another shape raises, it never computes in float instead.
The weight goes in as the transposed view of its ``[N, K]`` rows (B
column-major): cuBLASLt then runs its IMMA tensor-core kernel, where a
row-major ``[K, N]`` copy runs a WMMA kernel 5.6x slower at the MFA's
shape on the H100 and is refused at some shapes (PERF.md).
On CPU tensors the product is a float64 GEMM of the int8 values, exact
(every partial sum is an integer below 2^53), cast to int32.
``int8_matmul.launches`` counts the card's products.
"""

from __future__ import annotations

from typing import Optional

import torch


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """xq [M, K] int8 @ wq [N, K]^T int8 -> [M, N] int32, exact."""
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise ValueError(f"int8_matmul takes int8 operands, got {xq.dtype} and {wq.dtype}")
    m, k = xq.shape
    n = wq.shape[0]
    if xq.device.type == "cpu":
        return (xq.double() @ wq.double().t()).to(torch.int32)
    if xq.device.type != "cuda":
        raise ValueError(f"int8_matmul runs on cpu or cuda tensors, got {xq.device}")
    if m <= 16 or k % 8 or n % 8:
        raise ValueError(f"the card's int8 product takes m > 16 and k, n multiples of 8; got m={m}, k={k}, n={n}")
    out = torch._int_mm(xq.contiguous(), wq.contiguous().t())
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0


def quantize_rows(x: torch.Tensor, floor: float) -> tuple:
    """(int8 values, f32 scale [..., 1]): symmetric per row of the last axis."""
    xf = x.to(torch.float32)
    scale = torch.clamp_min(xf.abs().amax(-1, keepdim=True), floor) / 127.0
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8), scale


def dynamic_int8_dot(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ w^T (+ bias) with dynamic symmetric int8 quantization.

    x [..., in] float; w [out, in] float (the port's Linear and 1x1 conv
    layout; JAX's kernel is its transpose); returns [..., out] float32.
    """
    xq, sx = quantize_rows(x, 1e-8)
    wq, sw = quantize_rows(w, 1e-12)  # [out, in], [out, 1]
    y = int8_matmul(xq.reshape(-1, xq.shape[-1]), wq).reshape(*x.shape[:-1], w.shape[0])
    y = y.to(torch.float32) * (sx * sw.reshape(-1))
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y
