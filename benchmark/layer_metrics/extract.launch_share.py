"""The share of the traced stretch spent in the span ``extract.launch``,
the embed call: the host's enqueue of K1, CMVN and the model: the span's
host seconds over the stretch's window. None without a trace or where
the program has no such span."""

SPAN = "extract.launch"


def read(result):
    t = result.trace
    if t is None or t.window_s <= 0:
        return None
    try:
        from asv_subtools_tpu_torch.utils.profiling import totals
    except ImportError:  # a program without spans
        return None
    got = totals().get(SPAN)
    return None if got is None else 100.0 * got[1] / t.window_s
