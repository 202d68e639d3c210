"""Readers that per-layer metrics of more than one cell share. A metric's
own file (``layer_metrics/<metric>.py``) names its reader:
``from benchmark.readers import idle_share as read``."""

from benchmark.counts import kernels, peaks

K1_KERNELS = ("fbank_kernel", "fbank_mma_kernel")


def idle_share(result):
    """The share of the traced stretch in which nothing ran on the card (no
    kernel, copy or memset)."""
    t = result.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def k1_roofline(result):
    """K1 (``csrc/fbank.cu``) in the traced stretch: the least time its
    launches' work needs (one a batch or a step, at the shape of its
    padded wave) over the device time of its kernels."""
    t = result.trace
    spent = t.time_of(K1_KERNELS) if t is not None else 0.0
    if spent <= 0:
        return None
    bins = result.config["model"]["input_dim"]
    need = sum(peaks.bound_s(*kernels.k1(b, s, bins)) for b, s in t.work)
    return 100.0 * need / spent


def mfu(result):
    """The window's model FLOPs utilization: the operations of the work the
    window completed (the network counted on the plain reference at the
    work's own frames, plus K1's DFT and mel products; the driver's
    ``window_flops``) over the window times the H100's dense bf16 peak."""
    c = result.counters
    if "window_flops" not in c or not c.get("window_s"):
        return None
    return 100.0 * c["window_flops"] / (c["window_s"] * peaks.BF16_FLOPS)
