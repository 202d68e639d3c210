"""The share of the card's busy time in the traced stretch spent in the
Conformer's ``conv2d2`` subsampling front: the device seconds between the
event pairs of the span ``conformer.subsample`` (one a batch: two 3x3
convs over the [T, 80] map, the Dense to the attention width, the
scale), over the stretch's busy seconds. None without a trace or where
the program has no such span."""

SPAN = "conformer.subsample"


def read(result):
    t = result.trace
    if t is None or t.busy_s <= 0:
        return None
    try:
        from asv_subtools_tpu_torch.utils.profiling import totals
    except ImportError:  # a program without spans
        return None
    got = totals().get(SPAN)
    if got is None or got[2] is None:
        return None
    return 100.0 * got[2] / t.busy_s
