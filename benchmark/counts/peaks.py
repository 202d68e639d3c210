"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet: dense
rates without sparsity, at its 700 W limit). Every roofline and MFU of
the benchmark is a share of these."""

BF16_FLOPS = 989e12     # tensor cores, bf16 and fp16
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the work can take: the larger of its operations at
    the bf16 peak and its bytes at the memory's peak."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
