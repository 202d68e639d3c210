"""K3 (``csrc/res2_chain.cu``, the Res2Net chains) in the traced stretch:
the least time of its work (three launches a batch, one a SE-Res2 block,
at the padded batch's frames) over the device time of its kernels."""

from benchmark.counts import kernels, peaks
from benchmark.reference import fbank

KERNELS = ("res2_kernel", "res2_mma_kernel")
BLOCKS = 3


def read(result):
    t = result.trace
    spent = t.time_of(KERNELS) if t is not None else 0.0
    if spent <= 0:
        return None
    c = result.config["model"]["channels"]
    need = sum(BLOCKS * peaks.bound_s(*kernels.k3(b, fbank.num_frames(s), c)) for b, s in t.work)
    return 100.0 * need / spent
