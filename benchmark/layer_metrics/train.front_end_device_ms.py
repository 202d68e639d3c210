"""The card's time a traced train step in the span ``train.front_end``, the
fused fbank K1, CMVN and SpecAugment: the device seconds between the
span's two CUDA events, summed over the stretch, over its steps, in ms.
None without a trace or where the program has no such span."""

SPAN = "train.front_end"


def read(result):
    t = result.trace
    if t is None or not t.work:
        return None
    try:
        from asv_subtools_tpu_torch.utils.profiling import totals
    except ImportError:  # a program without spans
        return None
    got = totals().get(SPAN)
    if got is None or got[2] is None:
        return None
    return 1e3 * got[2] / len(t.work)
