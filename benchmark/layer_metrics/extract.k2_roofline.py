"""K2 (``csrc/att_pooling.cu``, ECAPA's attentive statistics pooling) in
the traced stretch: the least time of its work (one launch a batch over
the MFA's output at the padded batch's frames) over the device time of
its kernels."""

from benchmark.counts import kernels, peaks
from benchmark.reference import fbank

KERNELS = ("att_stats_kernel", "glob_kernel", "attend_kernel", "attend_mma_kernel", "combine_kernel")


def read(result):
    t = result.trace
    spent = t.time_of(KERNELS) if t is not None else 0.0
    if spent <= 0:
        return None
    c = result.config["model"]["mfa_conv"]
    need = sum(peaks.bound_s(*kernels.k2(b, fbank.num_frames(s), c)) for b, s in t.work)
    return 100.0 * need / spent
