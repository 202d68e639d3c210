"""MFU of the traced stretch of a Conformer extraction run: the operations
of the stretch's batches over its window times the H100's dense bf16
peak. A batch's operations are the network's at its padded shape,
counted on the plain reference (``model_flops.network_flops``, once a
distinct shape), plus K1's DFT and mel products.

Unlike ``extract.mfu``, which counts each utterance at its own frames
through ``model_flops.per_utterance``, this counts padded frames: the
Conformer's attention grows with T'^2, so the affine count that
``per_utterance`` interpolates does not hold, and an exact count a
length would take a count at every length. Padding is thus counted as
work here; ``extract.pad_share`` says how much of it there is."""

from benchmark.counts import kernels, model_flops, peaks
from benchmark.reference import fbank


def read(result):
    t = result.trace
    if t is None or not t.work or t.window_s <= 0:
        return None
    cfg = result.config
    bins = cfg["model"]["input_dim"]
    network = {}
    flops = 0.0
    for b, s in t.work:
        if (b, s) not in network:
            network[(b, s)] = model_flops.network_flops(cfg, fbank.num_frames(s), b)
        flops += network[(b, s)] + kernels.k1(b, s, bins)[0]
    return 100.0 * flops / (t.window_s * peaks.BF16_FLOPS)
