"""The share of the traced stretch spent in the span ``extract.copy_out``,
the embeddings' copy to the host, which waits for the card to finish the
batch: the span's host seconds over the stretch's window. None without a
trace or where the program has no such span."""

SPAN = "extract.copy_out"


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
